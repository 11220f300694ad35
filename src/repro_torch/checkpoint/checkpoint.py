"""Checkpointing: npz arrays + JSON manifest, the reference's format.

The on-disk format of ``repro/checkpoint/checkpoint.py``, so a checkpoint
written by one package restores in the other:
  * ``save``: flattens the state tree to path-keyed arrays (dict keys and
    list indices joined by ``||``), writes one ``arrays.npz`` + a
    ``manifest.json`` (step, tree structure in JAX's ``PyTreeDef`` notation,
    keys, shapes, dtypes) into ``step_{step:09d}``.  Atomic via tmp-dir
    rename: a crash mid-save never corrupts the latest checkpoint.
  * ``restore``: rebuilds the tree of ``like``, each leaf a tensor on
    ``device`` (or on the device of ``like``'s leaf).
  * In a process group every rank calls ``save`` and rank 0 alone writes,
    the others waiting for it at a barrier (so no rank resumes from a step
    still being written).  A state sharded over a mesh (DTensor leaves:
    the mesh train step's) is saved whole: each DTensor leaf is gathered
    (``distributed.fsdp.full_tensor``), so the files are the one-device
    state's and any mesh shape, or either package, restores them.
    ``restore`` into such a ``like`` gives each rank its blocks of the
    whole arrays under each leaf's placements.
  * ``latest_step`` / retention for periodic checkpointing.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_SEP = "||"


def _paths(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _treedef(tree: Any) -> str:
    """The tree's structure as JAX prints a ``PyTreeDef``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _whole(leaf) -> torch.Tensor:
    """A leaf whole; a DTensor's gathered (a collective)."""
    from ..distributed.fsdp import full_tensor

    return full_tensor(leaf) if _is_dtensor(leaf) else leaf


def save(ckpt_dir: str | Path, step: int, state: Any, *, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step:09d}"
    ranked = dist.is_initialized()
    writer = not ranked or dist.get_rank() == 0
    # every rank gathers each DTensor leaf; only the writer keeps a host copy
    flat = {}
    for path, leaf in _paths(state):
        whole = _whole(leaf)
        if writer:
            flat[_SEP.join(path)] = whole.detach().cpu().numpy()
        del whole
    if not writer:                      # rank 0 writes; the others wait for it
        dist.barrier()
        return final
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({_treedef(state)})",
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    _retain(ckpt_dir, keep)
    if ranked:
        dist.barrier()
    return final


def _retain(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(p.name for p in ckpt_dir.glob("step_*") if p.is_dir())
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str | Path, step: int, like: Any,
            device: str | torch.device | None = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    a tensor of the saved dtype on ``device``, or, when None, on the device
    of ``like``'s leaf; where ``like``'s leaf is a DTensor, this rank's
    block of the saved array under its placements, as a DTensor on its
    mesh."""
    from ..distributed.fsdp import from_whole, spec_of

    path = Path(ckpt_dir) / f"step_{step:09d}"
    with np.load(path / "arrays.npz") as data:
        def load(keys, leaf):
            dev = leaf.device if device is None else device
            x = torch.from_numpy(np.array(data[_SEP.join(keys)]))
            if _is_dtensor(leaf):
                return from_whole(x.to(leaf.to_local().device), spec_of(leaf),
                                  leaf.device_mesh)
            return x.to(dev)

        def build(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [build(v, prefix + (str(i),)) for i, v in enumerate(tree)]
            return load(prefix, tree)

        return build(like)


class CheckpointManager:
    """Periodic save + resume helper used by the training driver."""

    def __init__(self, ckpt_dir: str | Path, every_steps: int = 50,
                 keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.every = every_steps
        self.keep = keep

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.every == 0 and step > 0:
            save(self.dir, step, state, keep=self.keep)
            return True
        return False

    def resume(self, like: Any, device: str | torch.device | None = None):
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        return restore(self.dir, step, like, device), step
