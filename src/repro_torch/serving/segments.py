"""Segment execution: run a contiguous unit range of a model on one node.

This is the paper's S_j made executable.  The orchestrator's ModelGraph units
are [embed, block_0..block_{L-1}, lm_head]; a :class:`SegmentRunner` takes a
(lo, hi) unit range and runs exactly those units, consuming/producing boundary
activations.  Chaining runners over a split scheme reproduces the monolithic
forward — re-splitting changes WHERE layers run, never WHAT they compute.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..models import transformer
from ..models.api import ModelBundle
from ..models.common import apply_norm

__all__ = ["BoundSegment", "SegmentChain", "SegmentRunner", "split_params"]


def _slice_blocks(params: Any, lo: int, hi: int) -> Any:
    """Layers [lo, hi) of the stacked blocks: views, never copies."""
    return transformer.tree_map(lambda a: a[lo:hi], params["blocks"])


@dataclass
class SegmentRunner:
    """Executes graph units [lo, hi) for one architecture.

    ``local=False`` (default) indexes block stacks GLOBALLY — ``params`` is
    the full parameter tree and the runner picks its own layers out of it.
    ``local=True`` expects the segment-local view produced by
    :func:`split_params` (what actually ships to a node): block stacks are
    pre-sliced to this segment, so they are consumed whole.  Attention
    windows always use global layer positions.
    """

    bundle: ModelBundle
    lo: int
    hi: int
    local: bool = False

    @property
    def n_units(self) -> int:
        return len(self.bundle.model_graph())

    def __call__(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        """x: token ids [B,S] if lo==0, else boundary activations [B,S,d].

        Returns boundary activations, or fp32 logits if hi == n_units.
        """
        b = self.bundle
        if b.family != "transformer":
            raise NotImplementedError(f"{b.family} segments are not ported yet")
        cfg = b.cfg
        L = self.n_units - 2                 # number of blocks
        lo, hi = self.lo, self.hi
        if not 0 <= lo < hi <= L + 2:
            raise ValueError(f"segment [{lo}, {hi}) outside 0..{L + 2}")
        if lo == 0:
            x = transformer.embed_tokens(params, cfg, x)
            lo = 1
        blo, bhi = lo - 1, min(hi - 1, L)
        if bhi > blo:
            windows = cfg.windows()
            sub = params["blocks"] if self.local else _slice_blocks(params, blo, bhi)
            for i in range(bhi - blo):
                x = transformer.block_forward(
                    x, transformer.layer(sub, i), cfg,
                    window=int(windows[blo + i]))
        if hi == L + 2:
            x = apply_norm(x, params["final_norm"], cfg.norm)
            return transformer.logits_fn(params, cfg, x)
        return x


def split_params(bundle: ModelBundle, params: Any,
                 boundaries: tuple[int, ...]) -> list[Any]:
    """Per-segment param subsets (what RB ships to each node).

    One params-view per segment holding only what that segment's units need.
    Every tensor is a view of ``params`` (block stacks are sliced on their
    leading axis), so staging a split allocates no weight memory.
    """
    out = []
    L = len(bundle.model_graph()) - 2
    tied = bundle.cfg.tie_embeddings
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        seg: dict[str, Any] = {}
        if lo == 0 or (hi == L + 2 and tied):
            seg["embed"] = params["embed"]
        if hi == L + 2:
            seg["final_norm"] = params["final_norm"]
            if not tied:
                seg["head"] = params["head"]
        blo, bhi = max(lo - 1, 0), min(hi - 1, L)
        if bhi > blo:
            seg["blocks"] = _slice_blocks(params, blo, bhi)
        out.append(seg)
    return out


@dataclass
class BoundSegment:
    """A :class:`SegmentRunner` bound to the params it runs with."""

    runner: SegmentRunner
    params: Any

    @property
    def lo(self) -> int:
        return self.runner.lo

    @property
    def hi(self) -> int:
        return self.runner.hi

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.runner(self.params, x)


@dataclass
class SegmentChain:
    """The segment-execution entrypoint: a split scheme bound to params.

    Each segment is bound to the :func:`split_params` view of its own units —
    the tree a node actually holds in deployment.  ``transfer_hook(j, x)`` —
    e.g. an :class:`~repro_torch.serving.transfer.ActivationTransport` —
    sees the activations crossing boundary ``j`` and returns what arrives on
    the other side.
    """

    bundle: ModelBundle
    params: Any
    boundaries: tuple[int, ...]
    transfer_hook: Any = None
    segments: list[BoundSegment] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        pairs = list(zip(self.boundaries[:-1], self.boundaries[1:]))
        views = split_params(self.bundle, self.params, self.boundaries)
        self.segments = [
            BoundSegment(SegmentRunner(self.bundle, lo, hi, local=True), view)
            for (lo, hi), view in zip(pairs, views)
        ]

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        x = tokens
        n = len(self.bundle.model_graph())
        for j, seg in enumerate(self.segments):
            x = seg(x)
            if self.transfer_hook is not None and seg.hi < n:
                x = self.transfer_hook(j, x)
        return x
