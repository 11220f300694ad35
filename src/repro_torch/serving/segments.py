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

from ..models import griffin, mamba2, transformer
from ..models.api import ModelBundle
from ..models.common import apply_norm, layer, tree_map

__all__ = ["BoundSegment", "SegmentChain", "SegmentRunner", "split_params"]

_MODELS = {"transformer": transformer, "mamba2": mamba2, "griffin": griffin}


def _slice_blocks(params: Any, lo: int, hi: int) -> Any:
    """Layers [lo, hi) of the stacked blocks: views, never copies."""
    return tree_map(lambda a: a[lo:hi], params["blocks"])


@dataclass
class SegmentRunner:
    """Executes graph units [lo, hi) for one architecture.

    ``local=False`` (default) indexes block stacks GLOBALLY — ``params`` is
    the full parameter tree and the runner picks its own layers out of it.
    ``local=True`` expects the segment-local view produced by
    :func:`split_params` (what actually ships to a node): block stacks are
    pre-sliced to this segment, so they are consumed whole.  Layer-position
    effects (attention windows, Griffin's layer-kind pattern) always use
    global positions; Griffin's ``groups`` and ``tail`` are shipped whole
    and indexed globally in both modes.
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
        fam = b.family
        model = _MODELS.get(fam)
        if model is None:
            raise NotImplementedError(f"{fam} segments are not ported yet")
        cfg = b.cfg
        L = self.n_units - 2                 # number of blocks
        lo, hi = self.lo, self.hi
        if not 0 <= lo < hi <= L + 2:
            raise ValueError(f"segment [{lo}, {hi}) outside 0..{L + 2}")
        if lo == 0:
            x = model.embed_tokens(params, cfg, x)
            lo = 1
        blo, bhi = lo - 1, min(hi - 1, L)
        if bhi > blo and fam == "griffin":
            for li in range(blo, bhi):
                x = griffin.layer_forward(
                    x, *griffin.layer_params(params, cfg, li), cfg)
        elif bhi > blo and fam == "transformer":
            x = self._transformer_blocks(params, x, blo, bhi)
        elif bhi > blo:
            sub = params["blocks"] if self.local else _slice_blocks(params, blo, bhi)
            for i in range(bhi - blo):
                x = mamba2.block_forward(x, layer(sub, i), cfg)
        if hi == L + 2:
            x = apply_norm(x, params["final_norm"], cfg.norm)
            return model.logits_fn(params, cfg, x)
        return x

    def _transformer_blocks(self, params: Any, x: torch.Tensor, blo: int,
                            bhi: int) -> torch.Tensor:
        """Global layers [blo, bhi): the lead blocks among them first (their
        dense config, window 0), then the stacked ones at their global
        windows.  A local view holds only this segment's lead blocks and
        stacked layers."""
        cfg = self.bundle.cfg
        nl = transformer.n_lead(cfg)
        windows = cfg.windows()
        for i in range(blo, min(bhi, nl)):
            lp = params["lead_blocks"][i - blo if self.local else i]
            x = transformer.block_forward(x, lp, transformer.lead_config(cfg),
                                          window=0)
        slo, shi = max(blo - nl, 0), bhi - nl
        if shi > slo:
            sub = params["blocks"] if self.local else \
                _slice_blocks(params, slo, shi)
            for i in range(shi - slo):
                x = transformer.block_forward(x, layer(sub, i), cfg,
                                              window=int(windows[nl + slo + i]))
        return x


def split_params(bundle: ModelBundle, params: Any,
                 boundaries: tuple[int, ...]) -> list[Any]:
    """Per-segment param subsets (what RB ships to each node).

    One params-view per segment holding only what that segment's units need.
    Every tensor is a view of ``params`` (block stacks are sliced on their
    leading axis, DeepSeek-V2's ``lead_blocks`` list to the segment's share,
    ``prefix_proj`` goes with the embedding; Griffin's ``groups`` and
    ``tail`` go whole, as in the reference), so staging a split allocates no
    weight memory.
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
        if lo == 0 and "prefix_proj" in params:
            seg["prefix_proj"] = params["prefix_proj"]
        blo, bhi = max(lo - 1, 0), min(hi - 1, L)
        nl = transformer.n_lead(bundle.cfg) if bundle.family == "transformer" else 0
        if bhi > blo and "blocks" in params:
            if blo < nl:
                seg["lead_blocks"] = params["lead_blocks"][blo:min(bhi, nl)]
            slo, shi = max(blo - nl, 0), bhi - nl
            if shi > slo:
                seg["blocks"] = _slice_blocks(params, slo, shi)
        elif bhi > blo:                      # griffin
            seg["groups"] = params["groups"]
            seg["tail"] = params["tail"]
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
