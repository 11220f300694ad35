"""Infrastructure-failure injection for the edge fleet simulator.

The paper motivates adaptive orchestration with *infrastructural*
fluctuation; load traces (background utilization, backhaul bandwidth) cover
only half of it.  This module injects the failure classes, edge-cluster
style (cf. Parthasarathy & Krishnamachari: node/link failure as a
first-class re-optimization trigger):

* **Random node churn** — per-node exponential MTBF/MTTR up/down cycles.
* **Correlated blast** — a fixed set of nodes dies at one instant (rack
  power loss / backhaul cut) and revives together after ``blast_mttr_s``.
* **Link flaps** — Poisson-arriving windows during which a link runs at a
  small fraction of its traced bandwidth.

All randomness is pre-generated at construction from ``spec.seed``, so the
injected timeline is a pure function of (spec, horizon): seed-paired A/B
arms (failure handling on vs off) see *bit-identical* failures, and a run is
reproducible regardless of how often the simulator queries it.

A dead node is expressed purely through ``SystemState`` — the same channel
the load traces use, so every consumer (pricing kernels, Eq. 4 masks,
triggers) reacts without special-casing:

* ``mem_bytes → 0``: every hosted segment violates Eq. 4 immediately, the
  migration DP's memory mask excludes the node, and
  :class:`~repro_torch.core.fleet_eval.BatchedRepairPass` moves segments off it.
* ``background_util → 0.99``: the derate makes the node cost-prohibitive
  (latencies stay finite via the cost model's ``_EPS`` guards — an exact
  zero capacity would poison session EWMAs with infinities).
* links to/from the node drop to ~zero bandwidth: sessions whose chain
  crosses the node raise bandwidth triggers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.cost_model import SystemState

__all__ = ["FailureSpec", "FailureInjector"]

_DEAD_UTIL = 0.99       # cost-model background-utilization cap
_DEAD_LINK_BW = 1.0     # bytes/s: effectively down, but finite latencies


@dataclass(frozen=True)
class FailureSpec:
    """Failure-injection knobs (frozen: rides inside ``FleetSimConfig``).

    ``mtbf_s=None`` disables random node churn; ``blast_at_s=None`` disables
    the correlated blast; empty ``flap_links`` disables flapping.  The
    default spec therefore injects NOTHING — wiring it in must leave the
    fleet path bit-identical (test-enforced).
    """

    seed: int = 0
    # random per-node churn: exponential time-between-failures / repair
    mtbf_s: float | None = None
    mttr_s: float = 10.0
    # nodes exempt from RANDOM churn (the blast ignores this): keep the
    # ingress/home node alive so the scenario stays well-posed
    protected_nodes: tuple[int, ...] = ()
    # correlated blast: `blast_nodes` die together at `blast_at_s` and
    # revive together `blast_mttr_s` later
    blast_at_s: float | None = None
    blast_nodes: tuple[int, ...] = ()
    blast_mttr_s: float = 30.0
    # link flaps: Poisson windows of `flap_duration_s` at `flap_bw_frac`
    # of the traced bandwidth on each listed (i, j) link
    flap_links: tuple[tuple[int, int], ...] = ()
    flap_rate_per_s: float = 0.0
    flap_duration_s: float = 5.0
    flap_bw_frac: float = 0.02
    # failure-detection cadence: monitoring cycles a node may miss before
    # the HeartbeatRegistry declares it dead
    heartbeat_miss_limit: int = 3


def _down_intervals(rng: np.random.Generator, mtbf: float, mttr: float,
                    horizon: float) -> list[tuple[float, float]]:
    """Alternating up/down exponential draws → down windows in [0, horizon)."""
    out, t = [], float(rng.exponential(mtbf))
    while t < horizon:
        d = float(rng.exponential(mttr))
        out.append((t, min(t + d, horizon)))
        t += d + float(rng.exponential(mtbf))
    return out


class FailureInjector:
    """Deterministic failure timeline + ``SystemState`` overlay.

    The timeline (per-node down intervals, per-link flap windows) is drawn
    once in the constructor; :meth:`dead_nodes` / :meth:`apply` are pure
    reads, so handling-on and handling-off arms of a seed-paired A/B share
    the exact same infrastructure history.
    """

    def __init__(self, spec: FailureSpec, *, num_nodes: int,
                 horizon_s: float) -> None:
        self.spec = spec
        self.num_nodes = int(num_nodes)
        rng = np.random.default_rng(spec.seed)
        self._down: dict[int, list[tuple[float, float]]] = {
            n: [] for n in range(self.num_nodes)
        }
        if spec.mtbf_s is not None:
            for n in range(self.num_nodes):
                iv = _down_intervals(rng, spec.mtbf_s, spec.mttr_s, horizon_s)
                if n not in spec.protected_nodes:
                    self._down[n].extend(iv)
        if spec.blast_at_s is not None:
            t0 = float(spec.blast_at_s)
            t1 = t0 + float(spec.blast_mttr_s)
            for n in spec.blast_nodes:
                self._down[int(n)].append((t0, t1))
        self._flaps: dict[tuple[int, int], list[tuple[float, float]]] = {}
        for (i, j) in spec.flap_links:
            iv = ([] if spec.flap_rate_per_s <= 0 else _down_intervals(
                rng, 1.0 / spec.flap_rate_per_s, spec.flap_duration_s,
                horizon_s))
            self._flaps[(int(i), int(j))] = iv

    # -- pure timeline reads -------------------------------------------- #
    @property
    def any_failures(self) -> bool:
        return (any(self._down.values())
                or any(self._flaps.values()))

    def dead_nodes(self, t: float) -> tuple[int, ...]:
        return tuple(
            n for n in range(self.num_nodes)
            if any(a <= t < b for a, b in self._down[n])
        )

    def alive_nodes(self, t: float) -> tuple[int, ...]:
        dead = set(self.dead_nodes(t))
        return tuple(n for n in range(self.num_nodes) if n not in dead)

    def flapped_links(self, t: float) -> tuple[tuple[int, int], ...]:
        return tuple(
            lk for lk, iv in self._flaps.items()
            if any(a <= t < b for a, b in iv)
        )

    def apply(self, state: SystemState, t: float) -> SystemState:
        """C(t) with the failures at ``t`` overlaid (input not mutated)."""
        dead = self.dead_nodes(t)
        flapped = self.flapped_links(t)
        if not dead and not flapped:
            return state
        st = state.copy()
        for n in dead:
            st.mem_bytes[n] = 0.0
            st.background_util[n] = _DEAD_UTIL
            st.link_bw[n, :] = _DEAD_LINK_BW
            st.link_bw[:, n] = _DEAD_LINK_BW
            st.link_bw[n, n] = np.inf
        for (i, j) in flapped:
            frac = self.spec.flap_bw_frac
            st.link_bw[i, j] = max(_DEAD_LINK_BW, st.link_bw[i, j] * frac)
            st.link_bw[j, i] = max(_DEAD_LINK_BW, st.link_bw[j, i] * frac)
        return st
