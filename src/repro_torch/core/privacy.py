"""Privacy constraints (paper Eq. 5 / 9): trusted sets + validation."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .cost_model import SystemState
from .graph import ModelGraph

__all__ = ["TrustPolicy", "assert_privacy_ok"]


@dataclass(frozen=True)
class TrustPolicy:
    """N_trusted ⊆ N ∪ {c}; d_t(i) ∈ N_trusted ∀t for private segments."""

    trusted_nodes: frozenset[int]

    def mask(self, num_nodes: int) -> np.ndarray:
        m = np.zeros(num_nodes, dtype=bool)
        for i in self.trusted_nodes:
            if 0 <= i < num_nodes:
                m[i] = True
        return m

    def apply(self, state: SystemState) -> SystemState:
        st = state.copy()
        st.trusted = self.mask(state.num_nodes)
        return st


def assert_privacy_ok(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
) -> None:
    """Raise if any privacy-critical segment sits on an untrusted node."""
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        if graph.segment_has_private(lo, hi) and not state.trusted[assignment[j]]:
            raise PermissionError(
                f"privacy violation: segment [{lo},{hi}) on untrusted node "
                f"{state.names[assignment[j]]}"
            )
