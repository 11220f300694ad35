"""Tick-based 5G-MEC edge simulator driving the adaptive orchestrator(s).

The paper evaluates with an *analytical* ETSI-MEC latency model (Eq. 10)
rather than packet-level simulation; we do the same.  Every tick the simulator
(1) refreshes C(t) from utilization/bandwidth traces, (2) draws Poisson
request arrivals and prices their end-to-end latency through the current
segment chain via ``chain_latency`` (T_proc + T_queue + T_tx), (3) feeds the
Monitoring/CP module, and (4) runs one orchestrator monitoring cycle at the
configured interval.  The static baseline runs the identical loop with the
orchestrator disabled.

Two modes share the trace plumbing:

* :class:`EdgeSimulator` — the paper's single-session scenario (§IV).
* :class:`FleetSimulator` — multi-session mode: Poisson session churn
  (arrivals with exponential lifetimes, heterogeneous model graphs and QoS
  classes), every session priced against the fleet state in which the OTHER
  sessions appear as load, a :class:`~repro_torch.core.fleet.FleetOrchestrator`
  running batched migrate-vs-resplit cycles, and a
  :class:`~repro_torch.core.admission.FleetAdmissionController` pricing each
  arrival's achievable latency against residual capacity before it may join
  (accept / defer / reject, surfaced in the tick metrics and KPIs).

The loop itself is host numpy.  The device work is the orchestrator's: the
single-session re-split DP, and in fleet mode the resident tables, the fused
price and the monitoring cycle.  The fleet simulator runs on the
orchestrator's device (a region-sharded orchestrator's inners' device); a
tick copies back only what ``price_fleet`` returns, in one transfer.
"""

from __future__ import annotations

import heapq
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from ..core.admission import (
    AdmissionKind,
    AdmissionRequest,
    FleetAdmissionController,
)
from ..core.cost_model import (
    SystemState,
    Workload,
    chain_latency,
    link_loads,
    node_loads,
    node_queue_loads,
)
from ..core.fleet import (FleetOrchestrator, ShardedFleetOrchestrator,
                          session_induced_loads)
from ..core.graph import ModelGraph
from ..core.orchestrator import AdaptiveOrchestrator, DecisionKind
from ..core.profiling import CapacityProfiler, NodeSample
from ..core.triggers import QOS_CLASSES, QoSClass
from ..distributed.fault_tolerance import HeartbeatRegistry
from .chaos import ChaosInjector, ChaosSpec, InvariantChecker
from .failures import FailureInjector, FailureSpec
from .traces import Trace

__all__ = [
    "SimConfig", "TickMetrics", "SimResult", "EdgeSimulator",
    "FleetSimConfig", "FleetTickMetrics", "FleetSimResult", "FleetSimulator",
    "apply_traces",
]


def apply_traces(
    base_state: SystemState,
    util_traces: dict[int, Trace],
    bw_traces: dict[tuple[int, int], Trace],
    t: float,
) -> SystemState:
    """C(t): base capacities with the traced utilization/bandwidth applied."""
    st = base_state.copy()
    for node, tr in util_traces.items():
        st.background_util[node] = min(0.99, tr(t))
    for (i, j), tr in bw_traces.items():
        bw = tr(t)
        st.link_bw[i, j] = bw
        st.link_bw[j, i] = bw
    return st


@dataclass(frozen=True)
class SimConfig:
    duration_s: float = 120.0
    tick_s: float = 0.1
    monitor_interval_s: float = 1.0
    warmup_s: float = 0.0          # ticks before metrics are recorded
    seed: int = 0


@dataclass
class TickMetrics:
    t: float
    latency_s: float               # per-request E2E latency at this tick
    node_rho: np.ndarray           # offered load incl. inference
    min_link_bw: float
    arrivals: int
    completed: float               # throughput-effective completions
    decision: str = ""
    solver_time_s: float = 0.0


@dataclass
class SimResult:
    ticks: list[TickMetrics]
    reconfig_events: list[tuple[float, str, str]]  # (t, kind, reasons)

    def window(self, t0: float, t1: float) -> list[TickMetrics]:
        return [m for m in self.ticks if t0 <= m.t < t1]

    def kpis(self, t0: float, t1: float) -> dict[str, float]:
        """Steady-state KPIs over [t0, t1) — the paper's 10 s window."""
        w = self.window(t0, t1)
        if not w:
            return {}
        lat = np.array([m.latency_s for m in w])
        rho = np.stack([m.node_rho for m in w])
        arrivals = sum(m.arrivals for m in w)
        completed = sum(m.completed for m in w)
        # GPU util over nodes actually serving inference (rho above background)
        util = np.clip(rho, 0, 1)
        busy = util.max(axis=0) > 0.05
        return {
            "mean_latency_s": float(lat.mean()),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "ewma_latency_s": float(lat[-10:].mean()),
            "throughput_rps": completed / max(1e-9, (t1 - t0)),
            "offered_rps": arrivals / max(1e-9, (t1 - t0)),
            "gpu_util": float(util[:, busy].mean()) if busy.any() else 0.0,
            "max_rho": float(rho.max()),
        }


class EdgeSimulator:
    def __init__(
        self,
        *,
        graph,
        base_state: SystemState,
        workload: Workload,
        util_traces: dict[int, Trace],
        bw_traces: dict[tuple[int, int], Trace],
        orchestrator: AdaptiveOrchestrator | None,
        profiler: CapacityProfiler,
        boundaries: tuple[int, ...],
        assignment: tuple[int, ...],
        config: SimConfig = SimConfig(),
    ):
        self.graph = graph
        self.base_state = base_state
        self.workload = workload
        self.util_traces = util_traces
        self.bw_traces = bw_traces
        self.orch = orchestrator
        self.profiler = profiler
        self.boundaries = tuple(boundaries)
        self.assignment = tuple(assignment)
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)

    # ------------------------------------------------------------------ #
    def _state_at(self, t: float) -> SystemState:
        return apply_traces(self.base_state, self.util_traces, self.bw_traces, t)

    def run(self) -> SimResult:
        cfg = self.cfg
        ticks: list[TickMetrics] = []
        events: list[tuple[float, str, str]] = []
        next_monitor = 0.0
        if self.orch is not None and self.orch.current is None:
            self.orch.deploy_initial(self.boundaries, self.assignment, now=0.0)

        t = 0.0
        while t < cfg.duration_s:
            state = self._state_at(t)
            b, a = self.boundaries, self.assignment
            if self.orch is not None and self.orch.current is not None:
                b = self.orch.current.boundaries
                a = self.orch.current.assignment

            # ---- price this tick's requests through the chain (Eq. 10) ----
            lat = chain_latency(self.graph, b, a, state, self.workload)
            rho = node_loads(self.graph, b, a, state, self.workload)
            arrivals = int(self.rng.poisson(self.workload.arrival_rate * cfg.tick_s))
            # sustainable completions: node OR link overload throttles throughput
            qrho = node_queue_loads(self.graph, b, a, state, self.workload)
            lrho = link_loads(self.graph, b, a, state, self.workload)
            overload = max(1.0, float(qrho.max()), float(lrho.max()))
            completed = self.workload.arrival_rate * cfg.tick_s / overload

            # ---- feed Monitoring & CP ----
            for i in range(state.num_nodes):
                self.profiler.observe_node(
                    NodeSample(
                        i,
                        util_total=float(np.clip(rho[i], 0, 1)),
                        util_background=float(state.background_util[i]),
                    )
                )
            self.profiler.observe_links(state.link_bw)
            self.profiler.observe_latency(lat)

            decision_str, solver_t = "", 0.0
            if self.orch is not None and t >= next_monitor:
                d = self.orch.step(now=t)
                next_monitor = t + cfg.monitor_interval_s
                decision_str = d.kind.value
                solver_t = d.solver_time_s
                if d.kind in (DecisionKind.MIGRATE, DecisionKind.RESPLIT):
                    events.append((t, d.kind.value, "; ".join(d.reasons)))

            off = ~np.eye(state.num_nodes, dtype=bool)
            finite = state.link_bw[off]
            ticks.append(
                TickMetrics(
                    t=t, latency_s=lat, node_rho=rho,
                    min_link_bw=float(finite[np.isfinite(finite)].min()),
                    arrivals=arrivals, completed=completed,
                    decision=decision_str, solver_time_s=solver_t,
                )
            )
            t = round(t + cfg.tick_s, 9)
        return SimResult(ticks, events)


# --------------------------------------------------------------------------- #
# multi-session mode
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FleetSimConfig:
    """Churn + workload-sampling knobs for the multi-session simulator."""

    duration_s: float = 120.0
    tick_s: float = 0.1
    monitor_interval_s: float = 1.0
    seed: int = 0
    session_arrival_per_s: float = 0.2    # Poisson session-arrival rate
    mean_lifetime_s: float = 60.0         # exponential session lifetime
    max_sessions: int = 32                # hard session cap
    initial_sessions: int = 2             # sessions present at t=0
    arrival_rate_range: tuple[float, float] = (0.3, 2.0)   # per-session λ
    tokens_in_range: tuple[int, int] = (16, 96)     # inclusive bounds
    tokens_out_range: tuple[int, int] = (4, 16)
    ingress_nodes: tuple[int, ...] = (0, 1, 2)  # where sessions enter
    # admission control: price an arrival's best feasible latency against
    # its QoS class before it joins; False is the cap-only behavior (admit
    # blindly until max_sessions)
    admission: bool = True
    rho_ceiling: float = 1.0              # projected max node rho bound
    admission_queue_cap: int = 16         # defer-queue depth
    qos_mix: tuple[tuple[str, float], ...] = (
        ("interactive", 0.2), ("standard", 0.55), ("batch", 0.25),
    )
    # short-horizon capacity forecasting: attach a CapacityForecaster
    # to the orchestrator — admission prices arrivals against the worst
    # capacity within the horizon and the monitoring cycle raises proactive
    # migrate/re-split triggers before a predicted SLO breach.  The season
    # must match the periodic background signal in SAMPLES (the §IV home-MEC
    # saturation wave has a 40 s period at the 1 s monitoring cadence).
    # False keeps the reactive control plane (seed-paired A/B arm).
    forecast: bool = False
    forecast_horizon_steps: int = 12
    forecast_season_steps: int = 40
    forecast_residual_alpha: float = 0.2
    # failure injection: a FailureSpec drives node death and link
    # flaps through the SAME C(t) channel as the load traces.  None injects
    # nothing and leaves the fleet path bit-identical to the pre-failure
    # simulator (test-enforced).  ``failure_handling=False`` keeps the
    # injector but disconnects the control-plane response — no heartbeat
    # registry, no node-fail triggers, no preemption — the seed-paired OFF
    # arm of the storm A/B (both arms see the identical failure timeline).
    failures: FailureSpec | None = None
    failure_handling: bool = True
    # how long a preempted session waits in the defer queue for capacity to
    # return (None → its QoS class's admission defer patience)
    preempt_patience_s: float | None = None
    # control-plane chaos: a ChaosSpec pre-draws controller crashes,
    # RPC transport faults, and telemetry-corruption windows from its own
    # seed.  ``chaos_handling=True`` arms the resilient control plane —
    # journaled crash recovery (state restored from the npz journal, epoch
    # fencing against the pre-crash zombie), retrying fenced broadcasts, and
    # the telemetry guard.  ``False`` is the naive seed-paired OFF arm: the
    # restarted controller scrapes the data plane (defer queue, EWMAs,
    # forecast rings, and the version counter are simply lost), rollouts get
    # one unfenced attempt, and corrupt telemetry is trusted verbatim.
    chaos: "ChaosSpec | None" = None
    chaos_handling: bool = True
    # where the ON arm journals orchestrator state (None → a temp file)
    journal_path: str | None = None
    # joint fixed-point reconfiguration: resolve the whole triggered
    # set in ONE device-side red/black sweep loop so every accepted move is
    # priced against residuals containing the other accepted moves.  False
    # restores the cycle-start-greedy commit gate (the seed-paired OFF arm
    # of the --thrash A/B, which exhibits conflict-KEEP thrash at churn).
    fixed_point: bool = True
    fixed_point_sweeps: int = 8
    # region sharding: > 1 replicates the §IV cluster per region and
    # runs the fleet through a ShardedFleetOrchestrator — one resident
    # buffer/kernel per region, one vmapped cross-shard screen per cycle,
    # full per-region cycles only where triggers fire.  1 is the unsharded
    # path (and a ShardedFleetOrchestrator with one region delegates
    # verbatim — bit-identical, test-enforced).  Failure/chaos injection is
    # not yet region-aware: combining them with n_regions > 1 raises.
    n_regions: int = 1


@dataclass
class FleetTickMetrics:
    t: float
    n_sessions: int
    latencies: np.ndarray          # per-session E2E latency at this tick
    qos_violation_frac: float      # sessions over Θ.L_max
    node_rho: np.ndarray           # background + ALL sessions' induced load
    admitted: int                  # session arrivals this tick
    departed: int
    rejected: int                  # refused outright (incl. defer expiry)
    n_migrate: int = 0
    n_resplit: int = 0
    solver_time_s: float = 0.0
    deferred: int = 0              # parked in the admission queue this tick
    n_preempt: int = 0             # forecast-triggered (proactive) commits
    # failure-storm telemetry; all zero when no injector is wired
    n_dead_nodes: int = 0          # injector-dead nodes at this tick
    mem_violation_bytes: float = 0.0   # resident weights over node memory
    preempted: int = 0             # sessions revoked by admission this tick
    recovered: int = 0             # preempted sessions re-admitted this tick
    # fixed-point telemetry; conflict KEEPs also flow from the
    # legacy commit gate so the --thrash OFF arm can measure its thrash
    n_conflict_keep: int = 0       # dirtied-residual commit-gate rejects
    fp_sweeps: int = 0             # red/black sweeps the device loop ran

    @property
    def mean_latency_s(self) -> float:
        return float(self.latencies.mean()) if self.latencies.size else 0.0


@dataclass
class FleetSimResult:
    ticks: list[FleetTickMetrics]
    session_log: list[tuple[float, str, int, str]]  # (t, event, sid, arch)

    def window(self, t0: float, t1: float) -> list[FleetTickMetrics]:
        return [m for m in self.ticks if t0 <= m.t < t1]

    def kpis(self, t0: float, t1: float) -> dict[str, float]:
        w = [m for m in self.window(t0, t1) if m.n_sessions > 0]
        if not w:
            return {}
        # pool (tick, session) samples so p95 is a true tail percentile,
        # comparable to the single-session SimResult KPI of the same name.
        # A poisoned-telemetry arm (chaos) can price NaN latencies /
        # rho for a few ticks; those count as SLO breaches in
        # qos_violation_frac, not as latency samples.
        pool = np.concatenate([m.latencies for m in w])
        pool = pool[np.isfinite(pool)]
        if not pool.size:
            pool = np.zeros(1)
        viol = np.array([m.qos_violation_frac for m in w])
        rho = np.stack([m.node_rho for m in w])
        span = max(1e-9, t1 - t0)
        admitted = sum(m.admitted for m in w)
        rejected = sum(m.rejected for m in w)
        deferred = sum(m.deferred for m in w)
        # SLO-breach time: wall-clock during which ANY live session's
        # instantaneous latency exceeded its own QoS SLO (tick-quantized)
        tick_s = (float(np.median(np.diff([m.t for m in w])))
                  if len(w) > 1 else 0.1)
        breach_s = sum(tick_s for m in w if m.qos_violation_frac > 0)
        return {
            "mean_latency_s": float(pool.mean()),
            "p95_latency_s": float(np.percentile(pool, 95)),
            "qos_violation_frac": float(viol.mean()),
            "mean_sessions": float(np.mean([m.n_sessions for m in w])),
            "max_rho": float(np.nanmax(rho)),
            "mean_rho": float(np.nanmean(np.clip(rho, 0, 1))),
            "migrations_per_s": sum(m.n_migrate for m in w) / span,
            "resplits_per_s": sum(m.n_resplit for m in w) / span,
            "mean_solver_ms": 1e3 * float(np.mean(
                [m.solver_time_s for m in w if m.solver_time_s > 0] or [0.0]
            )),
            # admission KPIs (accept/reject/defer within the window)
            "admitted_per_s": admitted / span,
            "rejected_per_s": rejected / span,
            "deferred_per_s": deferred / span,
            "admit_frac": admitted / max(1, admitted + rejected),
            # forecast KPIs
            "slo_breach_minutes": breach_s / 60.0,
            "preemptive_migrations": float(sum(m.n_preempt for m in w)),
            # failure-storm KPIs: wall-clock with Eq. 4 violated
            # anywhere, and the revocation/recovery balance
            "mem_violation_minutes": sum(
                tick_s for m in w if m.mem_violation_bytes > 0
            ) / 60.0,
            "sessions_preempted": float(sum(m.preempted for m in w)),
            "sessions_recovered": float(sum(m.recovered for m in w)),
            # fixed-point KPIs: total dirtied-residual commit-gate
            # rejects (thrash signature of the cycle-start-greedy gate) and
            # total device red/black sweeps spent converging
            "conflict_keeps": float(sum(m.n_conflict_keep for m in w)),
            "fixed_point_sweeps": float(sum(m.fp_sweeps for m in w)),
        }

    def recovery_time_s(self, t_fail: float) -> float | None:
        """Seconds from ``t_fail`` until Eq. 4 holds fleet-wide for the rest
        of the run (zero resident-weight overflow on every node).

        0.0 when the failure never produced a violation; None when the
        fleet was still violating at the final tick (no recovery within the
        run) — the storm benchmark gates on this being small for the
        handling-ON arm.
        """
        after = [m for m in self.ticks if m.t >= t_fail]
        if not after:
            return 0.0
        bad = [m.t for m in after if m.mem_violation_bytes > 0]
        if not bad:
            return 0.0
        if bad[-1] >= after[-1].t:
            return None
        clean_from = next(m.t for m in after if m.t > bad[-1])
        return clean_from - t_fail

    def onset_max_rho(self, onsets, *, width_s: float = 3.0,
                      t0: float = 0.0, t1: float = float("inf")) -> float:
        """Max node ρ inside ``[onset, onset + width_s)`` windows — the
        spike-onset excursion KPI.  ``onsets`` are the background-spike
        start times of the driving trace (the simulator does not know the
        trace structure; scenario builders do — see
        :func:`repro_torch.edgesim.scenario.spike_onsets`).  Returns 0.0 when no
        onset window intersects [t0, t1)."""
        vals = [
            float(m.node_rho.max())
            for m in self.ticks
            if t0 <= m.t < t1
            and any(o <= m.t < o + width_s for o in onsets)
        ]
        return max(vals) if vals else 0.0


class FleetSimulator:
    """Multi-session churn simulator over a shared edge fleet.

    Session arrivals are Poisson; each session draws an architecture from
    ``catalog`` (heterogeneous model graphs), a workload from the configured
    ranges, an ingress node, and an exponential lifetime.  Every tick all
    active sessions are priced in ONE fused device dispatch over the
    orchestrator's resident fleet state
    (:meth:`~repro_torch.core.fleet.FleetOrchestrator.price_fleet` — each session
    against its effective C(t), other sessions folded into background/link
    load), and the :class:`FleetOrchestrator` runs a monitoring cycle at
    the configured interval.
    """

    def __init__(
        self,
        *,
        base_state: SystemState,
        catalog: list[tuple[str, ModelGraph]],
        util_traces: dict[int, Trace],
        bw_traces: dict[tuple[int, int], Trace],
        orchestrator: FleetOrchestrator,
        config: FleetSimConfig = FleetSimConfig(),
        admission: FleetAdmissionController | None = None,
    ):
        self.base_state = base_state
        self.catalog = catalog
        self.util_traces = util_traces
        self.bw_traces = bw_traces
        self.orch = orchestrator
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)
        # every device object the simulator builds goes where the
        # orchestrator's resident tables live
        self.device = (orchestrator.inners[0].device
                       if isinstance(orchestrator, ShardedFleetOrchestrator)
                       else orchestrator.device)
        # region sharding: the wrapper takes the sharded admission
        # controller; failure/chaos injection still assumes one global node
        # namespace end-to-end, so the combination is refused loudly rather
        # than silently mis-routing local node ids
        sharded = (isinstance(orchestrator, ShardedFleetOrchestrator)
                   and orchestrator.n_regions > 1)
        if sharded and (config.failures is not None
                        or config.chaos is not None):
            raise ValueError(
                "failure/chaos injection is not supported with "
                "n_regions > 1 yet")
        if config.forecast and orchestrator.forecaster is None:
            from ..core.forecast import CapacityForecaster, ForecastConfig

            orchestrator.forecaster = CapacityForecaster(ForecastConfig(
                horizon_steps=config.forecast_horizon_steps,
                season_steps=config.forecast_season_steps,
                sample_interval_s=config.monitor_interval_s,
                residual_alpha=config.forecast_residual_alpha,
            ), device=self.device)
        if admission is None and config.admission:
            if sharded:
                from ..core.admission import ShardedFleetAdmissionController

                admission = ShardedFleetAdmissionController(
                    orchestrator,
                    max_sessions=config.max_sessions,
                    rho_ceiling=config.rho_ceiling,
                    queue_cap=config.admission_queue_cap,
                )
            else:
                admission = FleetAdmissionController(
                    orchestrator,
                    max_sessions=config.max_sessions,
                    rho_ceiling=config.rho_ceiling,
                    queue_cap=config.admission_queue_cap,
                )
        self.admission = admission
        # failure injection + the control-plane response
        self._injector: FailureInjector | None = None
        self._hb: HeartbeatRegistry | None = None
        if config.failures is not None:
            self._injector = FailureInjector(
                config.failures, num_nodes=base_state.num_nodes,
                horizon_s=config.duration_s,
            )
            if config.failure_handling:
                self._hb = HeartbeatRegistry(
                    nodes=list(range(base_state.num_nodes)),
                    miss_limit=config.failures.heartbeat_miss_limit,
                )
                orchestrator.heartbeats = self._hb
        if self.admission is not None and config.preempt_patience_s is not None:
            self.admission.preempt_patience_s = config.preempt_patience_s
        # control-plane chaos
        self._chaos: ChaosInjector | None = None
        self.invariants: InvariantChecker | None = None
        self._flaky: list = []
        self.chaos_stats = {
            "controller_restarts": 0, "zombie_attempts": 0,
            "zombie_fenced": 0, "zombie_committed": 0,
            "lost_deferred": 0, "max_restore_wall_s": 0.0,
        }
        self._journal_file: str | None = None
        if config.chaos is not None:
            from ..core.broadcast import FlakyAgent, RolloutPolicy

            sp = config.chaos
            self._chaos = ChaosInjector(
                sp, num_nodes=base_state.num_nodes,
                horizon_s=config.duration_s,
            )
            if sp.rpc_fault_rate_per_s > 0 and self._chaos.rpc_windows:
                wrapped = []
                for a in orchestrator.broadcast.agents:
                    fa = FlakyAgent(
                        a, seed=sp.seed * 1000 + a.node_id,
                        drop_p=sp.rpc_drop_p, dup_p=sp.rpc_dup_p,
                        delay_p=sp.rpc_delay_p,
                        windows=self._chaos.rpc_windows,
                    )
                    wrapped.append(fa)
                    self._flaky.append(fa)
                orchestrator.broadcast.agents = wrapped
            # handling ON → bounded retries with backoff; OFF → one naive
            # unfenced attempt per RPC (the transport faults land raw)
            orchestrator.broadcast.policy = (
                RolloutPolicy() if config.chaos_handling
                else RolloutPolicy(max_attempts=1)
            )
            if not config.chaos_handling:
                orchestrator.telemetry_guard = None
            self.invariants = InvariantChecker(
                queue_cap=config.admission_queue_cap)
        mix = config.qos_mix
        self._qos_classes = tuple(QOS_CLASSES[name] for name, _ in mix)
        w = np.array([float(p) for _, p in mix])
        self._qos_probs = w / w.sum()

    # ------------------------------------------------------------------ #
    def _draw_session(
        self,
    ) -> tuple[str, ModelGraph, Workload, int, QoSClass, float]:
        """One arrival's full random tuple, INCLUDING its lifetime.

        Every draw is consumed here, per arrival, regardless of the
        admission outcome — so admission-on and admission-off runs of the
        same seed see the identical arrival stream (seed-paired A/B), and
        only the departure schedule differs through which sessions joined.
        """
        cfg = self.cfg
        arch, graph = self.catalog[int(self.rng.integers(len(self.catalog)))]
        wl = Workload(
            # endpoint=True: ranges are inclusive (and (n, n) means "fixed n")
            tokens_in=int(self.rng.integers(*cfg.tokens_in_range, endpoint=True)),
            tokens_out=int(self.rng.integers(*cfg.tokens_out_range, endpoint=True)),
            arrival_rate=float(self.rng.uniform(*cfg.arrival_rate_range)),
        )
        src = int(cfg.ingress_nodes[int(self.rng.integers(len(cfg.ingress_nodes)))])
        qos = self._qos_classes[
            int(self.rng.choice(len(self._qos_classes), p=self._qos_probs))
        ]
        life = float(self.rng.exponential(cfg.mean_lifetime_s))
        return arch, graph, wl, src, qos, life

    def _crash_restart(self, t: float,
                       pending_life: dict[int, float]) -> None:
        """Kill the controller process at ``t`` and bring up a successor.

        Handling ON: the successor restores the journal — sessions, trigger
        cooldown/hysteresis/throttle contexts, the defer queue, heartbeat
        registry, forecast rings, and the broadcast version counter — then
        claims a fresh epoch, fencing the pre-crash zombie.  Handling OFF:
        the successor scrapes active configs off the data plane; every
        piece of soft state (defer queue, EWMAs, cooldowns, forecast rings,
        the version counter) is simply gone, and no epoch is claimed.

        Either way the *data plane* (node agents with their staged/active
        configs and commit histories) survives — only the controller dies.
        """
        from ..core.broadcast import ReconfigurationBroadcast
        from ..core.fleet import FleetSession

        cfg = self.cfg
        old, old_ctrl = self.orch, self.admission
        old_bc = old.broadcast
        t0 = time.perf_counter()
        new_bc = ReconfigurationBroadcast(
            list(old_bc.agents), policy=old_bc.policy)
        forecaster = None
        if old.forecaster is not None:
            from ..core.forecast import CapacityForecaster

            forecaster = CapacityForecaster(old.forecaster.cfg,
                                            device=old.forecaster.device)
        new_orch = FleetOrchestrator(
            profiler=CapacityProfiler(
                base_state=old.profiler.base_state.copy(),
                ewma_alpha=old.profiler.ewma_alpha),
            broadcast=new_bc,
            thresholds=old.thresholds, weights=old.weights,
            cost_model=old.cost_model,
            device=old.device,
            splitter=old.splitter,      # solver components hold code and
            evaluator=old.evaluator,    # device buffers, not control state;
            kernel=old.kernel,          # reuse keeps the sim wall-clock sane
            repairer=old.repairer,
            max_units=old.max_units, local_rounds=old.local_rounds,
            min_improvement_frac=old.min_improvement_frac,
            bw_floor_frac=old.bw_floor_frac,
            solve_backoff_s=old.solve_backoff_s,
            backoff_tol_frac=old.backoff_tol_frac,
            forecaster=forecaster,
            use_fixed_point=old.use_fixed_point,
            fixed_point_sweeps=old.fixed_point_sweeps,
        )
        new_ctrl = None
        if old_ctrl is not None:
            new_ctrl = FleetAdmissionController(
                new_orch,
                max_sessions=old_ctrl.max_sessions,
                rho_ceiling=old_ctrl.rho_ceiling,
                queue_cap=old_ctrl.queue_cap,
                use_forecast=old_ctrl.use_forecast,
                preempt_patience_s=old_ctrl.preempt_patience_s,
            )
        if cfg.chaos_handling:
            lives = ([pending_life.get(id(req))
                      for _, req, _ in old_ctrl._queue]
                     if old_ctrl is not None else [])
            new_orch.load(self._journal_file, admission=new_ctrl,
                          claim_epoch=True)
            self._hb = new_orch.heartbeats
            if new_ctrl is not None:
                # restored requests are new objects; re-key the remaining
                # lifetimes by defer-queue position (order is journal-stable)
                for slot, life in zip(new_ctrl._queue, lives):
                    if life is not None:
                        pending_life[id(slot[1])] = life
        else:
            if old_ctrl is not None:
                self.chaos_stats["lost_deferred"] += old_ctrl.queued
            for sid, sess in old.sessions.items():
                held = [a.active_by[sid] for a in old_bc.agents
                        if sid in a.active_by]
                cfg0 = max(held, key=lambda c: c.version,
                           default=sess.config)
                new_orch.sessions[sid] = FleetSession(
                    sid=sid, graph=sess.graph, workload=sess.workload,
                    source_node=sess.source_node, arch=sess.arch,
                    input_bytes_per_token=sess.input_bytes_per_token,
                    qos=sess.qos, config=cfg0, t_admitted=t,
                )
            new_orch._next_sid = max(old.sessions, default=-1) + 1
            new_orch.telemetry_guard = None
            if self._hb is not None and cfg.failures is not None:
                self._hb = HeartbeatRegistry(
                    nodes=list(range(self.base_state.num_nodes)),
                    miss_limit=cfg.failures.heartbeat_miss_limit,
                )
                new_orch.heartbeats = self._hb
        self.chaos_stats["controller_restarts"] += 1
        self.chaos_stats["max_restore_wall_s"] = max(
            self.chaos_stats["max_restore_wall_s"],
            time.perf_counter() - t0)
        self.orch, self.admission = new_orch, new_ctrl
        # the dead controller's in-flight rollout lands AFTER the restart:
        # fenced by the successor's epoch claim on the ON arm, committed
        # over the recovered state on the OFF arm — exactly the coherence
        # violation the invariant checker exists to catch
        if self._chaos.spec.zombie_after_crash and old.sessions:
            sid = max(old.sessions)
            zcfg = old.sessions[sid].config
            if zcfg is not None:
                self.chaos_stats["zombie_attempts"] += 1
                z = old_bc.rollout(zcfg.boundaries, zcfg.assignment,
                                   reason="zombie", now=t, session=sid)
                if z is None:
                    self.chaos_stats["zombie_fenced"] += 1
                else:
                    self.chaos_stats["zombie_committed"] += 1

    def run(self) -> FleetSimResult:
        cfg = self.cfg
        orch = self.orch
        ctrl = self.admission
        ticks: list[FleetTickMetrics] = []
        log: list[tuple[float, str, int, str]] = []
        departures: list[tuple[float, int]] = []   # heap of (t_depart, sid)
        pending_life: dict[int, float] = {}        # id(queued req) → lifetime
        depart_at: dict[int, float] = {}           # sid → scheduled departure
        next_monitor = 0.0
        inj = self._injector
        chaos = self._chaos
        crash_i = 0

        def _overlay(state: SystemState, t: float) -> SystemState:
            if inj is not None:
                state = inj.apply(state, t)
            if chaos is not None:
                state = chaos.corrupt(state, t)
            return state

        def _admit(t: float) -> str:
            """One arrival through admission control; returns the outcome."""
            arch, graph, wl, src, qos, life = self._draw_session()
            if ctrl is None:  # no admission control: blind admit until the cap
                if len(orch.sessions) >= cfg.max_sessions:
                    log.append((t, "reject", -1, arch))
                    return "reject"
                sid = orch.admit(graph, wl, source_node=src, arch=arch,
                                 now=t, qos=qos)
                heapq.heappush(departures, (t + life, sid))
                depart_at[sid] = t + life
                log.append((t, "admit", sid, arch))
                return "admit"
            req = AdmissionRequest(graph, wl, source_node=src, arch=arch,
                                   qos=qos, t_submit=t)
            v = ctrl.request(req, now=t)
            if v.kind is AdmissionKind.ACCEPT:
                heapq.heappush(departures, (t + life, v.sid))
                depart_at[v.sid] = t + life
                log.append((t, "admit", v.sid, arch))
                return "admit"
            if v.kind is AdmissionKind.DEFER:
                pending_life[id(req)] = life
                log.append((t, "defer", -1, arch))
                return "defer"
            log.append((t, "reject", -1, arch))
            return "reject"

        # admissions plan against C(0) WITH traces applied (at t=0 the home
        # MEC may already be in a saturation spike), not the construction-
        # time base state
        orch.profiler.base_state = _overlay(apply_traces(
            self.base_state, self.util_traces, self.bw_traces, 0.0), 0.0)
        for _ in range(cfg.initial_sessions):
            _admit(0.0)

        # journaled recovery: persist orchestrator + admission state
        # so a crash-restart resumes from the last end-of-tick snapshot
        last_sig: tuple | None = None
        if chaos is not None and cfg.chaos_handling:
            path = cfg.journal_path
            if path is None:
                fd, path = tempfile.mkstemp(
                    prefix="fleet-journal-", suffix=".npz")
                os.close(fd)
            self._journal_file = path
            orch.save(path, admission=ctrl)

        t = 0.0
        while t < cfg.duration_s:
            if (chaos is not None and crash_i < len(chaos.crash_times)
                    and t >= chaos.crash_times[crash_i]):
                while (crash_i < len(chaos.crash_times)
                       and t >= chaos.crash_times[crash_i]):
                    crash_i += 1
                self._crash_restart(t, pending_life)
                orch, ctrl = self.orch, self.admission
            for fa in self._flaky:
                fa.now = t
            state = _overlay(apply_traces(self.base_state, self.util_traces,
                                          self.bw_traces, t), t)
            orch.profiler.base_state = state
            if self._hb is not None:
                # alive nodes announce themselves every tick; a dead node's
                # silence accumulates into a miss-limit declaration at the
                # monitoring cadence (HeartbeatRegistry.tick runs in step()),
                # and the first beat after repair revives it
                for node in inj.alive_nodes(t):
                    self._hb.beat(node)

            departed = 0
            while departures and departures[0][0] <= t:
                _, sid = heapq.heappop(departures)
                if sid in orch.sessions:
                    sess = orch.depart(sid)
                    depart_at.pop(sid, None)
                    log.append((t, "depart", sid, sess.arch))
                    departed += 1
            admitted = rejected = deferred = recovered = 0
            # retry the defer queue first — departures may have freed capacity
            if ctrl is not None:
                for req, v in ctrl.poll(t):
                    life = pending_life.pop(
                        id(req), float(cfg.mean_lifetime_s)
                    )
                    if v.kind is AdmissionKind.ACCEPT:
                        heapq.heappush(departures, (t + life, v.sid))
                        depart_at[v.sid] = t + life
                        if req.preempted:
                            recovered += 1
                            log.append((t, "recover", v.sid, req.arch))
                        else:
                            log.append((t, "admit", v.sid, req.arch))
                        admitted += 1
                    else:  # defer timeout → final reject
                        log.append((t, "expire", -1, req.arch))
                        rejected += 1
            for _ in range(int(self.rng.poisson(
                    cfg.session_arrival_per_s * cfg.tick_s))):
                outcome = _admit(t)
                if outcome == "admit":
                    admitted += 1
                elif outcome == "defer":
                    deferred += 1
                else:
                    rejected += 1

            # ---- price every session against the shared fleet state ----
            # one fused device dispatch over the orchestrator's resident
            # buffers (each row against its own effective C(t)) replaces the
            # per-session Python chain_latency loop + O(fleet) load table;
            # `now` lets the forecaster append this tick's C(t) sample
            # (sample-interval gated) inside the same dispatch
            sids, lat_arr, rho = orch.price_fleet(state, now=t)
            slo_arr = np.asarray([
                orch.sessions[sid].qos.latency_slo_s
                if orch.sessions[sid].qos is not None
                else orch.thresholds.latency_max_s
                for sid in sids
            ])

            # ---- feed Monitoring & CP ----
            for i in range(state.num_nodes):
                orch.profiler.observe_node(NodeSample(
                    i,
                    util_total=float(np.clip(rho[i], 0, 1)),
                    util_background=float(state.background_util[i]),
                ))
            orch.profiler.observe_links(state.link_bw)
            if lat_arr.size:
                orch.profiler.observe_latency(float(lat_arr.mean()))

            n_mig = n_rs = n_pre = n_preempted = 0
            n_ck = fp_sw = 0
            solver_t = 0.0
            if orch.sessions and t >= next_monitor:
                fd = orch.step(now=t)
                next_monitor = t + cfg.monitor_interval_s
                n_mig, n_rs = fd.n_migrate, fd.n_resplit
                n_pre = fd.n_preempt
                n_ck, fp_sw = fd.n_conflict_keep, fd.fixed_point_sweeps
                solver_t = fd.solver_time_s
                if (self._hb is not None and ctrl is not None
                        and fd.infeasible_sids):
                    # the orchestrator TRIED (forced migrate + batched
                    # repair) and the surviving fleet still cannot host
                    # these sessions — revoke the most expendable until
                    # Eq. 4 holds; each rides the defer queue back in when
                    # capacity returns, keeping its remaining lifetime
                    for sess, req in ctrl.preempt_overload(t, state=state):
                        n_preempted += 1
                        remaining = depart_at.pop(sess.sid, t) - t
                        log.append((t, "preempt", sess.sid, sess.arch))
                        if req is not None and remaining > 0:
                            pending_life[id(req)] = remaining
                if self.invariants is not None:
                    self.invariants.check(
                        t=t, orch=orch, agents=orch.broadcast.agents,
                        admission=ctrl)

            mem_over = 0.0
            if inj is not None and orch.sessions:
                used = np.zeros(state.num_nodes)
                for s in orch.sessions.values():
                    used += session_induced_loads(s, state)[2]
                mem_over = float(
                    np.maximum(0.0, used - state.mem_bytes).sum()
                )

            ticks.append(FleetTickMetrics(
                t=t,
                n_sessions=len(orch.sessions),
                latencies=lat_arr,
                # a NaN latency (poisoned telemetry priced verbatim) is not
                # "fast" — it is an unserved SLO and counts as a breach
                qos_violation_frac=(
                    float(((lat_arr > slo_arr)
                           | ~np.isfinite(lat_arr)).mean())
                    if lat_arr.size else 0.0
                ),
                node_rho=rho,
                admitted=admitted, departed=departed, rejected=rejected,
                n_migrate=n_mig, n_resplit=n_rs, solver_time_s=solver_t,
                deferred=deferred, n_preempt=n_pre,
                n_dead_nodes=len(inj.dead_nodes(t)) if inj is not None else 0,
                mem_violation_bytes=mem_over,
                preempted=n_preempted, recovered=recovered,
                n_conflict_keep=n_ck, fp_sweeps=fp_sw,
            ))
            if self._journal_file is not None:
                # re-journal when durable control-plane state moved: the
                # session set, the version counter, the defer queue, or a
                # monitoring cycle (EWMAs / forecast rings / heartbeats)
                sig = (orch._next_sid, orch.broadcast._version,
                       len(orch.sessions),
                       ctrl.queued if ctrl is not None else 0,
                       next_monitor)
                if sig != last_sig:
                    orch.save(self._journal_file, admission=ctrl)
                    last_sig = sig
            t = round(t + cfg.tick_s, 9)
        return FleetSimResult(ticks, log)
