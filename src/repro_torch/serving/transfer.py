"""Inter-segment activation transfer: byte accounting + int8 compression.

Models the network hand-off between split-inference nodes (paper Fig. 2) and
implements the compression-aware transfer of [26]: bf16 boundary activations
are 2× compressed to int8 with per-token scales (kernel K2), cutting T_tx on
constrained backhaul links.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..kernels import ops as kops

__all__ = ["TransferStats", "ActivationTransport"]


@dataclass
class TransferStats:
    transfers: int = 0
    raw_bytes: float = 0.0
    wire_bytes: float = 0.0
    per_boundary: dict = field(default_factory=dict)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / self.wire_bytes if self.wire_bytes else 1.0


@dataclass
class ActivationTransport:
    """transfer_hook for :class:`~repro_torch.serving.segments.SegmentChain`."""

    compress: bool = False
    stats: TransferStats = field(default_factory=TransferStats)

    def __call__(self, boundary: int, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        raw = b * s * d * x.element_size()
        if self.compress:
            q, scales = kops.quantize_int8(x.reshape(b * s, d))
            wire = q.numel() + scales.numel() * 4
            x = kops.dequantize_int8(q, scales, x.dtype).reshape(b, s, d)
        else:
            wire = raw
        self.stats.transfers += 1
        self.stats.raw_bytes += raw
        self.stats.wire_bytes += wire
        self.stats.per_boundary[boundary] = \
            self.stats.per_boundary.get(boundary, 0.0) + wire
        return x
