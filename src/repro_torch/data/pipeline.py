"""Deterministic sharded synthetic token pipeline (the reference's, numpy).

The port's own copy of ``repro/data/pipeline.py``: the same generator calls
in the same order, so its batches equal the reference's bit for bit.

Markov-chain token stream (fixed transition structure per seed) rather than
iid-uniform, so a ~100M model trained a few hundred steps shows a real loss
drop (the reference's examples/train_quickstart.py asserts it).  Sharding:
each data-parallel host slice draws a disjoint, deterministic key stream;
resuming at step k reproduces the exact batch k regardless of restarts
(the kill-and-resume drill relies on this).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int                      # global batch (sequences per step)
    seq_len: int
    seed: int = 0
    branching: int = 8              # out-degree of the Markov chain


class SyntheticTokens:
    """next(it) -> {'tokens': [B,S] int32, 'labels': [B,S] int32}."""

    def __init__(self, cfg: DataConfig, *, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        assert cfg.batch % num_shards == 0
        rng = np.random.default_rng(cfg.seed)
        # fixed sparse transition table: token t -> one of `branching` successors
        self._table = rng.integers(0, cfg.vocab,
                                   size=(cfg.vocab, cfg.branching), dtype=np.int32)
        self._step = 0

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        b_local = cfg.batch // self.num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + self.shard)
        toks = np.empty((b_local, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b_local)
        choices = rng.integers(0, cfg.branching,
                               size=(b_local, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self._table[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        out = self.batch_at(self._step)
        self._step += 1
        return out

    def seek(self, step: int) -> None:
        self._step = step
