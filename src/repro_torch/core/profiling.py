"""Monitoring & Capacity Profiling (CP) — paper §III-A module 1.

Ingests raw per-node / per-link samples each monitoring cycle, smooths them
(EWMA), and produces (a) the environment state E(t) consumed by
``ShouldReconfigure`` and (b) an updated ``SystemState`` C(t) for the solver.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cost_model import SystemState
from .triggers import EWMA, TriggerState

__all__ = ["NodeSample", "CapacityProfiler"]


@dataclass(frozen=True)
class NodeSample:
    """One raw CP(n_j, t) observation (paper Eq. 1).

    ``util_total`` is what the GPU counters report (other tenants + our own
    inference pods); ``util_background`` excludes our own pods (per-tenant
    cgroup/MIG accounting).  The solver must plan against *background* load —
    planning against total load creates a flee-from-self feedback loop where
    whichever nodes currently host segments always look saturated.
    """

    node: int
    util_total: float           # combined CPU/GPU utilization ∈ [0,1]
    util_background: float      # utilization excluding our own segments
    mem_free_bytes: float = 0.0
    net_egress_bps: float = 0.0


@dataclass
class CapacityProfiler:
    base_state: SystemState
    ewma_alpha: float = 0.3
    _util: dict[int, EWMA] = field(default_factory=dict)
    _util_total: dict[int, EWMA] = field(default_factory=dict)
    _lat: EWMA = field(default_factory=lambda: EWMA(0.3))
    _link_bw: np.ndarray | None = None

    def observe_node(self, s: NodeSample) -> None:
        self._util.setdefault(s.node, EWMA(self.ewma_alpha)).update(s.util_background)
        self._util_total.setdefault(s.node, EWMA(self.ewma_alpha)).update(s.util_total)

    def observe_links(self, bw_matrix_bps: np.ndarray) -> None:
        if self._link_bw is None:
            self._link_bw = bw_matrix_bps.astype(np.float64).copy()
        else:
            a = self.ewma_alpha
            self._link_bw = a * bw_matrix_bps + (1 - a) * self._link_bw

    def observe_latency(self, e2e_latency_s: float) -> None:
        self._lat.update(e2e_latency_s)

    # ------------------------------------------------------------------ #
    def system_state(self) -> SystemState:
        """Updated C(t): base capacities + smoothed live utilization/links."""
        st = self.base_state.copy()
        for node, e in self._util.items():
            st.background_util[node] = np.clip(e.get(st.background_util[node]), 0.0, 0.99)
        if self._link_bw is not None:
            st.link_bw = self._link_bw.copy()
        return st

    def env_state(self) -> TriggerState:
        """E(t) for the trigger check (U_max fires on TOTAL node utilization)."""
        st = self.system_state()
        off_diag = ~np.eye(st.num_nodes, dtype=bool)
        finite = st.link_bw[off_diag]
        finite = finite[np.isfinite(finite)]
        max_total = max(
            (e.get(0.0) for e in self._util_total.values()),
            default=float(st.background_util.max()),
        )
        return TriggerState(
            ewma_latency_s=self._lat.get(0.0),
            max_node_util=float(max_total),
            min_link_bw_bps=float(finite.min()) if finite.size else float("inf"),
        )
