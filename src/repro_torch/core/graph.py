"""Computational-graph abstraction the orchestrator partitions.

The paper (§III-B) treats a foundation model M as a chain of k consecutive
segments S = {S_1..S_k} cut from the model's computational graph.  Every
architecture in ``repro_torch.configs`` exposes ``model_graph()`` returning a
:class:`ModelGraph` — a sequential chain of :class:`GraphNode` units (embedding,
transformer blocks / SSD blocks / RG-LRU blocks, LM head) annotated with the
quantities the cost model Φ needs:

  * ``flops``           forward FLOPs *per token* through the unit
  * ``weight_bytes``    parameter bytes resident on whichever node hosts it
  * ``act_out_bytes``   activation bytes *per token* crossing the unit's output
                        boundary (what a split at that boundary must transfer)
  * ``privacy_critical`` True for units that touch raw user data (paper Eq. 5/9)

A *split scheme* is a strictly-increasing boundary vector
``b = [0, b_1, .., b_{k-1}, L]``; segment j covers nodes ``[b_j, b_{j+1})``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "GraphNode",
    "ModelGraph",
    "SplitScheme",
    "validate_boundaries",
]


@dataclass(frozen=True)
class GraphNode:
    """One indivisible unit of the model's computational graph."""

    name: str
    flops: float                 # fwd FLOPs per token
    weight_bytes: float
    act_out_bytes: float         # bytes/token at this unit's output boundary
    privacy_critical: bool = False

    def scaled(self, factor: float) -> "GraphNode":
        return dataclasses.replace(
            self, flops=self.flops * factor, weight_bytes=self.weight_bytes * factor
        )


@dataclass(frozen=True)
class SplitScheme:
    """Boundary vector b with b[0]=0, b[-1]=L (paper's S = {S_1..S_k})."""

    boundaries: tuple[int, ...]

    @property
    def num_segments(self) -> int:
        return len(self.boundaries) - 1

    def segments(self) -> list[tuple[int, int]]:
        b = self.boundaries
        return [(b[i], b[i + 1]) for i in range(len(b) - 1)]

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return "|".join(f"[{a}:{b})" for a, b in self.segments())


def validate_boundaries(boundaries: Sequence[int], num_nodes: int) -> None:
    b = list(boundaries)
    if len(b) < 2 or b[0] != 0 or b[-1] != num_nodes:
        raise ValueError(f"boundaries must run 0..{num_nodes}, got {b}")
    if any(b[i + 1] <= b[i] for i in range(len(b) - 1)):
        raise ValueError(f"boundaries must be strictly increasing, got {b}")


class ModelGraph:
    """Sequential computational graph + prefix-sum segment queries."""

    def __init__(self, name: str, nodes: Sequence[GraphNode]):
        if not nodes:
            raise ValueError("empty graph")
        self.name = name
        self.nodes: tuple[GraphNode, ...] = tuple(nodes)
        self.flops = np.array([u.flops for u in nodes], dtype=np.float64)
        self.weight_bytes = np.array([u.weight_bytes for u in nodes], dtype=np.float64)
        self.act_out_bytes = np.array([u.act_out_bytes for u in nodes], dtype=np.float64)
        self.privacy = np.array([u.privacy_critical for u in nodes], dtype=bool)
        # prefix sums with leading 0 so segment [i, j) = p[j] - p[i]
        self._flops_ps = np.concatenate([[0.0], np.cumsum(self.flops)])
        self._wbytes_ps = np.concatenate([[0.0], np.cumsum(self.weight_bytes)])
        self._priv_ps = np.concatenate([[0], np.cumsum(self.privacy.astype(np.int64))])

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def total_flops(self) -> float:
        return float(self._flops_ps[-1])

    @property
    def total_weight_bytes(self) -> float:
        return float(self._wbytes_ps[-1])

    def segment_flops(self, lo: int, hi: int) -> float:
        return float(self._flops_ps[hi] - self._flops_ps[lo])

    def segment_weight_bytes(self, lo: int, hi: int) -> float:
        return float(self._wbytes_ps[hi] - self._wbytes_ps[lo])

    def segment_has_private(self, lo: int, hi: int) -> bool:
        return bool(self._priv_ps[hi] - self._priv_ps[lo])

    def boundary_act_bytes(self, boundary: int) -> float:
        """Bytes/token transferred when cutting *after* unit ``boundary-1``."""
        if boundary <= 0 or boundary >= len(self.nodes):
            return 0.0  # chain endpoints: input tokens / final logits stay local
        return float(self.act_out_bytes[boundary - 1])

    def even_split(self, k: int) -> SplitScheme:
        """Baseline static split: k segments with ~equal FLOPs (paper §III-C 1)."""
        if not 1 <= k <= len(self.nodes):
            raise ValueError(f"cannot cut {len(self.nodes)} units into {k} segments")
        target = self.total_flops / k
        bounds = [0]
        acc = 0.0
        for i, f in enumerate(self.flops[:-1]):
            acc += f
            if acc >= target * len(bounds) and len(bounds) < k:
                bounds.append(i + 1)
        while len(bounds) < k:  # degenerate tail — force distinct cuts
            bounds.append(bounds[-1] + 1)
        bounds.append(len(self.nodes))
        # ensure strictly increasing after the forced appends
        for i in range(1, len(bounds)):
            if bounds[i] <= bounds[i - 1]:
                bounds[i] = bounds[i - 1] + 1
        if bounds[-1] != len(self.nodes):
            bounds[-1] = len(self.nodes)
        validate_boundaries(bounds, len(self.nodes))
        return SplitScheme(tuple(bounds))

    def subgraph_names(self, lo: int, hi: int) -> list[str]:
        return [u.name for u in self.nodes[lo:hi]]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ModelGraph({self.name!r}, units={len(self)}, "
            f"flops/token={self.total_flops:.3e}, weights={self.total_weight_bytes/1e9:.2f} GB)"
        )


def make_transformer_graph(
    *,
    name: str,
    num_layers: int,
    d_model: int,
    flops_per_layer_token: float,
    weight_bytes_per_layer: float,
    embed_weight_bytes: float,
    head_weight_bytes: float,
    head_flops_token: float,
    act_dtype_bytes: int = 2,
    privacy_prefix: int = 1,
    privacy_suffix: int = 1,
) -> ModelGraph:
    """Helper used by configs: embed + L blocks + head chain.

    ``privacy_prefix``/``privacy_suffix`` mark units that see raw tokens /
    produce final outputs as privacy-critical (paper: S_1 handles raw data,
    S_k generates outputs).
    """
    act = float(d_model * act_dtype_bytes)
    units: list[GraphNode] = [
        GraphNode("embed", flops=2.0 * d_model, weight_bytes=embed_weight_bytes,
                  act_out_bytes=act, privacy_critical=True)
    ]
    for i in range(num_layers):
        units.append(
            GraphNode(
                f"block_{i}",
                flops=flops_per_layer_token,
                weight_bytes=weight_bytes_per_layer,
                act_out_bytes=act,
            )
        )
    units.append(
        GraphNode("lm_head", flops=head_flops_token, weight_bytes=head_weight_bytes,
                  act_out_bytes=0.0, privacy_critical=privacy_suffix > 0)
    )
    # extend privacy prefix beyond the embedding if requested
    for i in range(1, max(1, privacy_prefix)):
        if i < len(units) - 1:
            units[i] = dataclasses.replace(units[i], privacy_critical=True)
    return ModelGraph(name, units)
