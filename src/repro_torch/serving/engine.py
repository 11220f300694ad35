"""Split-inference engine: the runtime half of the paper's framework.

Ties together:
  * the ACTIVE partition config (versioned, from the Reconfiguration
    Broadcast) — which segments exist and which node owns each,
  * per-segment parameter views (what RB stages on each node),
  * chained segment execution with activation transport (optionally int8),
  * live reconfiguration: ``apply_config`` swaps the split between requests
    with zero math change (equivalence tested against the monolith).

Node "execution" is in-process on one device, but every hand-off passes
through the transport layer, so per-boundary wire bytes match what a real
deployment would ship.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..core.broadcast import PartitionConfig
from ..core.graph import ModelGraph
from ..models.api import ModelBundle
from .segments import SegmentChain, SegmentRunner
from .transfer import ActivationTransport, TransferStats

__all__ = ["SplitInferenceEngine"]


@dataclass
class SplitInferenceEngine:
    bundle: ModelBundle
    params: Any
    transport: ActivationTransport = field(default_factory=ActivationTransport)
    config: PartitionConfig | None = None
    node_params: dict[int, list] = field(default_factory=dict)
    reconfigurations: int = 0
    chain: SegmentChain | None = None

    def graph(self) -> ModelGraph:
        return self.bundle.model_graph()

    # -------------------------------------------------------------- config --
    def apply_config(self, cfg: PartitionConfig) -> None:
        """Stage per-node segment params and activate the new split."""
        self.chain = SegmentChain(self.bundle, self.params, cfg.boundaries,
                                  transfer_hook=self.transport)
        staged: dict[int, list] = {}
        for j, (node, seg) in enumerate(zip(cfg.assignment,
                                            self.chain.segments)):
            staged.setdefault(node, []).append((cfg.boundaries[j],
                                                cfg.boundaries[j + 1],
                                                seg.params))
        self.node_params = staged
        if self.config is not None and cfg.version != self.config.version:
            self.reconfigurations += 1
        self.config = cfg

    def staged_bytes_per_node(self) -> dict[int, float]:
        """Weight bytes resident per node under the active split (Eq. 4)."""
        g = self.graph()
        out: dict[int, float] = {}
        if self.config is None:
            raise RuntimeError("apply_config first")
        for j, node in enumerate(self.config.assignment):
            lo, hi = self.config.boundaries[j], self.config.boundaries[j + 1]
            out[node] = out.get(node, 0.0) + g.segment_weight_bytes(lo, hi)
        return out

    # ------------------------------------------------------------ execution --
    def infer_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward through the active split chain; fp32 logits.

        Runs the staged :class:`SegmentChain` — every segment executes on
        its own :func:`split_params` view, exactly the tree its node holds.
        """
        if self.chain is None:
            raise RuntimeError("apply_config first")
        return self.chain(tokens)

    def infer_monolithic(self, tokens: torch.Tensor) -> torch.Tensor:
        """Reference single-node forward (equivalence oracle)."""
        n = len(self.graph())
        return SegmentRunner(self.bundle, 0, n)(self.params, tokens)

    def transfer_stats(self) -> TransferStats:
        return self.transport.stats
