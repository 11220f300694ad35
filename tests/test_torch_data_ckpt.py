"""The port's data pipeline, checkpoints, straggler detector and training
driver against the reference, on the CPU.

Batches, shards and ``seek`` are the reference's bit for bit; a checkpoint
written by either package restores in the other (same keys, arrays,
manifest); the straggler detector flags the same workers; and
``launch/train.main``'s kill-and-resume drill lands on the uninterrupted
run's loss and state bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest_step
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.distributed import StragglerDetector as JaxStragglerDetector
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import StragglerDetector
from repro_torch.launch import train
from repro_torch.models.common import tree_flatten, tree_map


@pytest.mark.parametrize("vocab,batch,seq,seed,branching", [
    (1000, 8, 32, 3, 8), (512, 4, 64, 0, 8), (32_000, 8, 256, 0, 8),
    (97, 6, 17, 11, 3)])
def test_batches_shards_and_seek_equal_reference(vocab, batch, seq, seed,
                                                 branching):
    kw = dict(vocab=vocab, batch=batch, seq_len=seq, seed=seed,
              branching=branching)
    mine, ref = SyntheticTokens(DataConfig(**kw)), JaxSyntheticTokens(JaxDataConfig(**kw))
    np.testing.assert_array_equal(mine._table, ref._table)
    for step in (0, 1, 7):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
    for it in (mine, ref):
        it.seek(5)
    for _ in range(2):
        a, b = next(mine), next(ref)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    if batch % 2 == 0:
        for shard in (0, 1):
            a = SyntheticTokens(DataConfig(**kw), shard=shard, num_shards=2)
            b = JaxSyntheticTokens(JaxDataConfig(**kw), shard=shard, num_shards=2)
            np.testing.assert_array_equal(a.batch_at(3)["labels"],
                                          b.batch_at(3)["labels"])
    full = mine.batch_at(0)
    np.testing.assert_array_equal(full["tokens"][:, 1:], full["labels"][:, :-1])


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(rng.standard_normal((2, 3), dtype=np.float32)),
                       "blocks": {"b": torch.tensor(rng.standard_normal((4,), dtype=np.float32))},
                       "lead": [{"x": torch.ones(2)}, {"x": torch.zeros(3)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": {"w": torch.zeros(2, 3)}}}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = _state()
    for step in (10, 20, 30, 40):
        save(tmp_path, step, state, keep=2)
    assert latest_step(tmp_path) == 40
    assert len(list(tmp_path.glob("step_*"))) == 2
    assert not list(tmp_path.glob(".tmp_*"))
    out = restore(tmp_path, 40, state)
    for a, b in zip(tree_flatten(out)[0], tree_flatten(state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mgr = CheckpointManager(tmp_path / "m", every_steps=5, keep=1)
    assert mgr.resume(state) == (None, 0)
    assert not mgr.maybe_save(3, state) and mgr.maybe_save(5, state)
    got, at = mgr.resume(state, device="cpu")
    assert at == 5 and torch.equal(got["opt"]["step"], state["opt"]["step"])


def test_checkpoints_cross_between_packages(tmp_path):
    state = _state(1)
    np_state = tree_map(lambda t: t.numpy(), state)
    save(tmp_path / "port", 3, state)
    jax_save(tmp_path / "ref", 3, np_state)
    # the same files: manifest (treedef, keys, shapes, dtypes) and arrays
    mp = json.loads((tmp_path / "port/step_000000003/manifest.json").read_text())
    mr = json.loads((tmp_path / "ref/step_000000003/manifest.json").read_text())
    assert mp == mr
    with np.load(tmp_path / "port/step_000000003/arrays.npz") as a, \
            np.load(tmp_path / "ref/step_000000003/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    # a port checkpoint through the reference's restore, and the reverse
    assert jax_latest_step(tmp_path / "port") == 3
    ref_out = jax_restore(tmp_path / "port", 3, np_state)
    for a, b in zip(jax.tree_util.tree_leaves(ref_out),
                    jax.tree_util.tree_leaves(np_state)):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = restore(tmp_path / "ref", 3, state)
    for a, b in zip(tree_flatten(mine)[0], tree_flatten(state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(4)
    mine, ref = StragglerDetector(), JaxStragglerDetector()
    assert mine.stragglers() == ref.stragglers() == []
    for _ in range(20):
        for w in range(6):
            t = float(rng.gamma(4.0, 0.05)) * (2.5 if w in (2, 5) else 1.0)
            mine.observe(w, t)
            ref.observe(w, t)
        assert mine.stragglers() == ref.stragglers()
    assert mine.stragglers() == [2, 5]
    mine.observe(0, float("nan"))
    ref.observe(0, float("nan"))
    assert mine.stragglers() == ref.stragglers()


def _ckpt_state(path, step):
    with np.load(path / f"step_{step:09d}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("compression", [False, True])
def test_kill_and_resume_reproduces_training(tmp_path, compression):
    """Fault drill through the training driver: run 1-20 with a checkpoint
    every 10, kill at 10, resume, and land on the uninterrupted run's loss
    and state, bit for bit."""
    argv = ["--device", "cpu", "--steps", "20", "--batch", "2", "--seq", "32",
            "--ckpt-every", "10", "--log-every", "100"]
    if compression:
        argv.append("--grad-compression")
    full = train.main(argv + ["--ckpt-dir", str(tmp_path / "full")])
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--ckpt-dir", str(tmp_path / "drill"),
                           "--kill-at-step", "10"])
    assert exc.value.code == 42
    assert latest_step(tmp_path / "drill") == 10
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "drill")])
    assert resumed["steps_run"] == 10 and full["steps_run"] == 20
    assert resumed["last_loss"] == full["last_loss"]
    a, b = _ckpt_state(tmp_path / "full", 20), _ckpt_state(tmp_path / "drill", 20)
    assert sorted(a) == sorted(b)
    assert ("residual||embed" in a) == compression and "opt||step" in a
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_driver_takes_one_device_only():
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--mesh-data", "2"])
    assert exc.value.code == 2
