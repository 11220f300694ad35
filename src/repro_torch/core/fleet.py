"""Fleet Orchestrator — multi-session Adaptive Split Orchestration.

:class:`~repro_torch.core.orchestrator.AdaptiveOrchestrator` runs the
paper's Alg. 1 for ONE inference session.  The edge fleet serves many
concurrent sessions (multi-tenant FM serving at the edge, cf.
arXiv:2504.03668), so this module lifts the same decision hierarchy to a
session *set* S = {s_1..s_m} sharing one C(t):

* **Shared capacity accounting** — every session plans against an effective
  state in which the OTHER sessions' placements appear as induced load:
  their λ·service-time folded into per-node background utilization, their
  boundary traffic shaving link bandwidth, and their resident weights
  shaving node memory (:meth:`FleetOrchestrator.effective_state`).  A
  migration by one session shifts the cost surface of all others.
* **Per-session triggers** — each session keeps its own EWMA latency against
  Θ.L_max; utilization and bandwidth triggers are fleet-level (they fire for
  every session hosted on the affected node/link).  Cool-downs and the
  anti-thrash hysteresis are likewise per-session.
* **Device-resident monitoring path** — the fleet's problem tensors live on
  the orchestrator's device across cycles as a
  :class:`~repro_torch.core.fleet_eval.FleetStateBuffers` row per session,
  updated incrementally on admit/depart/commit.  A monitoring cycle is one
  fused :class:`~repro_torch.core.fleet_eval.ResidentFleetKernel` pricing
  call (induced loads → effective C(t) → batched Φ → per-session trigger
  env) returning only O(B) trigger scalars to host, plus — only on cycles
  where something triggered — the red/black fixed point (or the legacy
  fused migrate) and, for sessions whose best migration still violates QoS,
  one batched :class:`~repro_torch.core.splitter.BatchedJointSplitter`
  re-split (Eq. 8) whose solutions are memory-repaired by ONE
  :class:`~repro_torch.core.fleet_eval.BatchedRepairPass` call over the
  violating set.  Each group of outputs comes to the host in one copy.

Churn (session admit/depart) is first-class: :meth:`admit` solves an initial
split against the current fleet load and deploys it through the shared
Reconfiguration Broadcast; :meth:`depart` releases the session's capacity.
Both apply row-level updates to the resident buffers; the orchestrator is
the buffers' only writer (see :mod:`repro_torch.core.fleet_eval`).
Admission *pricing* — accept/defer/reject against the residual capacity —
lives in :mod:`repro_torch.core.admission`; :meth:`FleetOrchestrator.save`
and :meth:`~FleetOrchestrator.load` journal the control plane (with the
admission controller's queue) so a restarted controller continues where
the crashed one stopped.

An operator with many MEC regions runs :class:`ShardedFleetOrchestrator`:
one :class:`FleetOrchestrator` per region over its region-local C(t), one
cross-shard screen a cycle that prices every region at once, full steps only
for the regions whose triggers fire, and a host aggregator that moves the
worst-breaching sessions into the region with the most headroom.

Every tensor lives on ``FleetOrchestrator.device`` (default ``"cuda"``,
which raises without a card); tests pass ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field, replace as _dc_replace

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.fault_tolerance import HeartbeatRegistry
from .broadcast import PartitionConfig, ReconfigurationBroadcast, _unwrap
from .cost_model import (
    AnalyticCostModel,
    CostModel,
    CostWeights,
    SystemState,
    Workload,
    link_loads,
    memory_violations,
    memory_violations_packed,
    region_slice,
    segment_service_time,
)
from .fleet_eval import (
    BatchedRepairPass,
    FleetCostEvaluator,
    FleetStateBuffers,
    ResidentFleetKernel,
    ShardedFleetState,
    gather_rows,
    pack_sessions,
    packed_induced_loads,
    to_host,
)
from .forecast import CapacityForecaster
from .graph import GraphNode, ModelGraph
from .orchestrator import Decision, DecisionKind
from .placement import Solution, local_search
from .profiling import CapacityProfiler
from .splitter import (
    BatchedJointSplitter,
    PackedProblem,
    SessionProblem,
    coalesce_same_node,
)
from .triggers import (
    EWMA,
    QOS_CLASSES,
    QoSClass,
    SolveThrottle,
    Thresholds,
    TriggerState,
    decision_gate,
    forecast_reconfigure,
    hysteresis_keep,
)

__all__ = ["FleetSession", "FleetDecision", "FleetOrchestrator",
           "ShardedFleetOrchestrator", "TelemetryGuard",
           "AdmissionRolloutError", "session_induced_loads", "JOURNAL_SCHEMA"]

# the reference package writes the same schema: a journal saved by one loads
# into the other
JOURNAL_SCHEMA = "fleet-journal/v1"


class AdmissionRolloutError(RuntimeError):
    """The two-phase deploy broadcast aborted during session admission.

    Raised instead of silently dropping the session so the admission
    controller can DEFER the request (a transport fault is transient — the
    defer queue retries it) rather than treat it as a capacity rejection.
    """


@dataclass
class FleetSession:
    """One tenant inference session: model chain + workload + live config."""

    sid: int
    graph: ModelGraph
    workload: Workload
    source_node: int = 0
    arch: str = ""
    input_bytes_per_token: float = 4.0
    qos: QoSClass | None = None        # None → fleet-default Θ.L_max applies
    config: PartitionConfig | None = None
    ewma_latency: EWMA = field(default_factory=lambda: EWMA(0.3))
    t_admitted: float = 0.0
    t_last_reconfig: float = float("-inf")
    decisions: list[Decision] = field(default_factory=list)
    # per-session solver duty-cycle state (see triggers.SolveThrottle)
    throttle: SolveThrottle = field(default_factory=SolveThrottle)
    # state-independent DP tensors, packed once per session: a re-split
    # re-solves against fresh C(t) but never re-coarsens the graph
    prepacked: PackedProblem | None = None


@dataclass(frozen=True)
class FleetDecision:
    """One fleet monitoring cycle: per-session outcomes + aggregate counts.

    ``solver_time_s`` is the whole cycle's wall time; ``eval_time_s`` the
    fused device dispatches (price + migrate) and ``pack_time_s`` any
    resident-buffer packing done within the cycle (row writes on commits;
    0 in steady state).
    """

    t: float
    per_session: dict[int, Decision]
    solver_time_s: float
    n_keep: int
    n_migrate: int
    n_resplit: int
    n_cooldown: int
    eval_time_s: float = 0.0
    pack_time_s: float = 0.0
    # commits raised by the PROACTIVE (forecast) trigger: the session's
    # observed env was inside Θ, its predicted env within the horizon wasn't
    n_preempt: int = 0
    # failure-storm cycle outputs: sessions forced into the solve set
    # by the node-fail trigger class, the dead set they fled, and the sids
    # the surviving fleet could NOT host this cycle (Eq. 4 infeasible after
    # migrate + batched repair) — the admission controller's revocation
    # path preempts from this set
    n_node_fail: int = 0
    dead_nodes: tuple[int, ...] = ()
    infeasible_sids: tuple[int, ...] = ()
    # KEEP taxonomy: a commit-gate KEEP caused by residuals another
    # session's commit dirtied THIS cycle (or by the fixed-point joint
    # guard) is a CONFLICT — the thrash the device fixed point exists to
    # eliminate — and must not be conflated with an ordinary no-gain
    # hysteresis KEEP
    n_conflict_keep: int = 0
    n_nogain_keep: int = 0
    # red/black sweeps the fixed-point dispatch ran this cycle (0 when no
    # row triggered or the legacy cycle-start-greedy path is active), and
    # whether its final joint Eq. 4 guard reverted the cycle
    fixed_point_sweeps: int = 0
    fixed_point_aborts: int = 0


def session_induced_loads(
    sess: FleetSession, state: SystemState
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(node ρ, link ρ, node weight bytes) that ``sess`` imposes on the fleet.

    Node load is the raw (un-derated) λ·service-time of each hosted segment —
    the same quantity :func:`repro_torch.core.cost_model.node_loads` adds on top of
    background utilization for a single session.
    """
    n = state.num_nodes
    node_rho = np.zeros(n)
    wbytes = np.zeros(n)
    if sess.config is None:
        return node_rho, np.zeros((n, n)), wbytes
    b, a = sess.config.boundaries, sess.config.assignment
    for j, (lo, hi) in enumerate(zip(b[:-1], b[1:])):
        node = a[j]
        svc = segment_service_time(
            sess.graph.segment_flops(lo, hi),
            sess.graph.segment_weight_bytes(lo, hi),
            node, state, sess.workload, derate=False,
        )
        node_rho[node] += sess.workload.arrival_rate * svc
        wbytes[node] += sess.graph.segment_weight_bytes(lo, hi)
    link_rho = link_loads(sess.graph, b, a, state, sess.workload)
    return node_rho, link_rho, wbytes


@dataclass
class TelemetryGuard:
    """Degraded-mode telemetry firewall in front of every pricing consumer.

    Real monitoring pipelines emit garbage: a scrape races a counter reset
    and a node's utilization arrives as NaN, a link probe divides by zero.
    Unguarded, one such sample would flow straight into the fused pricing
    and every output — latencies, trigger EWMAs, forecast rings — would go
    NaN *permanently* (NaN compares false, so no trigger would fire again).

    ``sanitize`` replaces a corrupt node's telemetry with its **last-good
    sample** and marks the node *quarantined* — a trigger-visible class
    distinct from ``node-fail``: the hardware is presumed alive (heartbeats
    still arrive), only its measurements are untrusted, so sessions on it
    are re-evaluated through the ordinary cooldown/throttle gate rather
    than force-committed.  A node corrupt for longer than
    ``staleness_budget_s`` stops being priced off stale data and degrades
    to conservative capacity (util 0.99, zero model memory, floor links) —
    the same shape a dead node takes — which makes migrating off it
    attractive.  Clean telemetry passes through untouched (same object, so
    guarded runs are bit-identical to unguarded ones until a fault).
    """

    staleness_budget_s: float = 30.0
    clamped_samples: int = 0
    _last_good: SystemState | None = None
    _bad_since: dict[int, float] = field(default_factory=dict)

    @property
    def quarantined(self) -> tuple[int, ...]:
        return tuple(sorted(self._bad_since))

    @staticmethod
    def _bad_nodes(state: SystemState) -> np.ndarray:
        lbw = np.asarray(state.link_bw, dtype=np.float64)
        llat = np.asarray(state.link_lat, dtype=np.float64)
        return (
            ~np.isfinite(np.asarray(state.background_util, dtype=np.float64))
            | np.isnan(np.asarray(state.flops_per_s, dtype=np.float64))
            | np.isnan(np.asarray(state.mem_bytes, dtype=np.float64))
            | np.isnan(np.asarray(state.mem_bw, dtype=np.float64))
            | np.isnan(lbw).any(axis=1) | np.isnan(lbw).any(axis=0)
            | np.isnan(llat).any(axis=1) | np.isnan(llat).any(axis=0)
        )

    def _substitute(self, st: SystemState, n: int, now: float) -> None:
        good = self._last_good
        fresh = (good is not None
                 and now - self._bad_since[n] <= self.staleness_budget_s)
        if fresh:
            st.background_util[n] = good.background_util[n]
            st.flops_per_s[n] = good.flops_per_s[n]
            st.mem_bytes[n] = good.mem_bytes[n]
            st.mem_bw[n] = good.mem_bw[n]
            st.link_bw[n, :] = good.link_bw[n, :]
            st.link_bw[:, n] = good.link_bw[:, n]
            st.link_lat[n, :] = good.link_lat[n, :]
            st.link_lat[:, n] = good.link_lat[:, n]
            return
        # stale beyond budget (or never seen good): conservative degraded
        # capacity — dead-node shaped, so placement flows away from it
        st.background_util[n] = 0.99
        st.mem_bytes[n] = 0.0
        st.flops_per_s[n] = max(1.0, float(np.nan_to_num(st.flops_per_s[n],
                                                         nan=1.0)))
        st.mem_bw[n] = max(1.0, float(np.nan_to_num(st.mem_bw[n], nan=1.0)))
        off = np.arange(st.num_nodes) != n
        st.link_bw[n, off] = 1.0
        st.link_bw[off, n] = 1.0
        st.link_bw[n, n] = np.inf
        st.link_lat[n, :] = np.nan_to_num(st.link_lat[n, :], nan=0.0)
        st.link_lat[:, n] = np.nan_to_num(st.link_lat[:, n], nan=0.0)

    def sanitize(self, state: SystemState,
                 now: float | None = None) -> SystemState:
        """Return a telemetry-trustworthy view of ``state``.

        Clean input with no live quarantine returns the SAME object (the
        zero-overhead fast path); otherwise a sanitized copy.
        """
        bad = self._bad_nodes(state)
        t = 0.0 if now is None else float(now)
        if not bad.any():
            if self._bad_since:
                self._bad_since.clear()
            self._last_good = state.copy()
            return state
        st = state.copy()
        for n in np.flatnonzero(bad):
            n = int(n)
            self.clamped_samples += 1
            self._bad_since.setdefault(n, t)
            self._substitute(st, n, t)
        for n in [n for n in self._bad_since if not bad[n]]:
            del self._bad_since[n]
        # remember the sanitized view: good nodes carry fresh telemetry,
        # quarantined ones their last-good (keeps substitution stable)
        self._last_good = st.copy()
        return st

    # -- snapshot ------------------------------------------------------- #
    def state_dict(self) -> dict:
        d: dict = {
            "staleness_budget_s": self.staleness_budget_s,
            "clamped_samples": self.clamped_samples,
            "bad_since": {str(k): v for k, v in self._bad_since.items()},
            "last_good": None,
        }
        if self._last_good is not None:
            d["last_good"] = _state_to_dict(self._last_good)
        return d

    def load_state_dict(self, d: dict) -> None:
        self.staleness_budget_s = float(d["staleness_budget_s"])
        self.clamped_samples = int(d["clamped_samples"])
        self._bad_since = {int(k): float(v)
                           for k, v in d["bad_since"].items()}
        self._last_good = (None if d["last_good"] is None
                           else _state_from_dict(d["last_good"]))


# --------------------------------------------------------------------- #
# journal (de)serialization helpers — plain-data codecs for the snapshot
# --------------------------------------------------------------------- #
def _graph_to_dict(g: ModelGraph) -> dict:
    return {"name": g.name, "nodes": [
        [n.name, float(n.flops), float(n.weight_bytes),
         float(n.act_out_bytes), bool(n.privacy_critical)] for n in g.nodes
    ]}


def _graph_from_dict(d: dict) -> ModelGraph:
    return ModelGraph(d["name"], [
        GraphNode(nm, fl, wb, ab, bool(pv)) for nm, fl, wb, ab, pv in d["nodes"]
    ])


def _state_to_dict(st: SystemState) -> dict:
    return {
        "flops_per_s": np.asarray(st.flops_per_s, dtype=np.float64).tolist(),
        "mem_bytes": np.asarray(st.mem_bytes, dtype=np.float64).tolist(),
        "background_util": np.asarray(st.background_util,
                                      dtype=np.float64).tolist(),
        "trusted": np.asarray(st.trusted, dtype=bool).tolist(),
        "link_bw": np.asarray(st.link_bw, dtype=np.float64).tolist(),
        "link_lat": np.asarray(st.link_lat, dtype=np.float64).tolist(),
        "mem_bw": np.asarray(st.mem_bw, dtype=np.float64).tolist(),
        "names": list(st.names),
    }


def _state_from_dict(d: dict) -> SystemState:
    return SystemState(
        flops_per_s=np.asarray(d["flops_per_s"], dtype=np.float64),
        mem_bytes=np.asarray(d["mem_bytes"], dtype=np.float64),
        background_util=np.asarray(d["background_util"], dtype=np.float64),
        trusted=np.asarray(d["trusted"], dtype=bool),
        link_bw=np.asarray(d["link_bw"], dtype=np.float64),
        link_lat=np.asarray(d["link_lat"], dtype=np.float64),
        mem_bw=np.asarray(d["mem_bw"], dtype=np.float64),
        names=tuple(d["names"]),
    )


def _qos_to_dict(q: QoSClass | None) -> dict | None:
    if q is None:
        return None
    return {"name": q.name, "latency_slo_s": q.latency_slo_s,
            "defer_timeout_s": q.defer_timeout_s}


def _qos_from_dict(d: dict | None) -> QoSClass | None:
    """The canonical ``QOS_CLASSES`` instance when name and numbers match
    (class identity feeds preemption order and the per-class KPIs)."""
    if d is None:
        return None
    q = QOS_CLASSES.get(d["name"])
    if (q is not None and q.latency_slo_s == d["latency_slo_s"]
            and q.defer_timeout_s == d["defer_timeout_s"]):
        return q
    return QoSClass(**d)


def _config_to_dict(c: PartitionConfig | None) -> dict | None:
    if c is None:
        return None
    return {"version": c.version, "boundaries": list(c.boundaries),
            "assignment": list(c.assignment), "reason": c.reason,
            "issued_at": c.issued_at, "session": c.session, "epoch": c.epoch}


def _config_from_dict(d: dict | None) -> PartitionConfig | None:
    if d is None:
        return None
    return PartitionConfig(
        version=int(d["version"]), boundaries=tuple(d["boundaries"]),
        assignment=tuple(d["assignment"]), reason=d["reason"],
        issued_at=float(d["issued_at"]), session=d["session"],
        epoch=int(d.get("epoch", 0)),
    )


def _workload_to_dict(w: Workload) -> dict:
    return {"tokens_in": w.tokens_in, "tokens_out": w.tokens_out,
            "arrival_rate": w.arrival_rate}


def _ewma_to_list(e: EWMA) -> list:
    return [e.alpha, e.value]


def _ewma_from_list(v: list) -> EWMA:
    return EWMA(float(v[0]), None if v[1] is None else float(v[1]))


@dataclass
class FleetOrchestrator:
    """Adaptive Split Orchestration over a set of concurrent sessions."""

    profiler: CapacityProfiler
    broadcast: ReconfigurationBroadcast
    thresholds: Thresholds = field(default_factory=Thresholds)
    weights: CostWeights = field(default_factory=CostWeights)
    # pricing provider: calibrated-vs-analytic is THIS one argument.  The
    # orchestrator threads it into the splitter/evaluator/kernel it owns and
    # calibrates every session graph ONCE at admission — from then on the
    # resident rows, induced loads, DP packs, and scalar re-prices all carry
    # the same (possibly measured) per-unit coefficients.  ``None`` →
    # :class:`~repro_torch.core.cost_model.AnalyticCostModel`.
    cost_model: CostModel | None = None
    # where the resident tables and every fleet program live; "cuda" raises
    # without a card — the CPU runs only when asked for
    device: str | torch.device = "cuda"
    # shared-units coarsening: heterogeneous catalog depths collapse into one
    # DP bucket (None → BatchedJointSplitter(shared_units=32) on `device`)
    splitter: BatchedJointSplitter | None = None
    max_units: int | None = 96         # DP coarsening cap (huge graphs)
    local_rounds: int = 6              # Φ local-search budget per decision
    min_improvement_frac: float = 0.10  # anti-thrash hysteresis
    bw_floor_frac: float = 0.05        # residual link bw floor under contention
    # per-session solver duty-cycle limit (instantiated per admitted session):
    # don't re-solve a session whose trigger context is unchanged since its
    # last (rejected) solve — level-based triggers otherwise re-solve every
    # cycle in a degraded steady state
    solve_backoff_s: float = 5.0
    backoff_tol_frac: float = 0.10
    # batched pricing / fused programs / batched repair (None → built on
    # `device`; components passed in are moved to `device`)
    evaluator: FleetCostEvaluator | None = None
    kernel: ResidentFleetKernel | None = None
    repairer: BatchedRepairPass | None = None
    # short-horizon capacity predictor: None → purely reactive.  When
    # set, its seasonal update rides every pricing dispatch, the monitoring
    # cycle raises proactive triggers off the forecast env, and admission
    # prices arrivals against the worst-case capacity within the horizon.
    forecaster: CapacityForecaster | None = None
    # liveness feed: None → no failure detection.  When set, every
    # monitoring cycle advances the registry one interval; sessions whose
    # config touches a newly-declared-dead node enter the solve set through
    # the `node-fail` trigger class, which bypasses cooldown, the solver
    # throttle, AND the commit hysteresis — a storm is just a large
    # triggered set riding the existing fused migrate/re-split dispatches
    heartbeats: HeartbeatRegistry | None = None
    # joint reconfiguration mode: ON runs the device red/black
    # fixed point over the triggered set — each accepted move is priced
    # against residuals containing every earlier move, so the host commit
    # gate never has to conflict-KEEP a candidate whose residuals another
    # commit dirtied.  OFF keeps the legacy cycle-start-greedy path.
    use_fixed_point: bool = True
    fixed_point_sweeps: int = 8

    # degraded-mode telemetry firewall (None → trust telemetry verbatim);
    # clean samples pass through bit-identically, so the guard is on by
    # default
    telemetry_guard: TelemetryGuard | None = field(
        default_factory=TelemetryGuard)
    degraded_cycles: int = 0           # fused-price-was-NaN KEEP-all cycles

    sessions: dict[int, FleetSession] = field(default_factory=dict)
    decisions: list[FleetDecision] = field(default_factory=list)
    _next_sid: int = 0
    # device-resident fleet state: rows owned by admit/depart/_commit ONLY
    _buffers: FleetStateBuffers | None = None
    full_rebuilds: int = 0             # cold repacks (≠ row-level updates)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        dev = self.device
        if self.splitter is None:
            self.splitter = BatchedJointSplitter(shared_units=32, device=dev)
        if self.evaluator is None:
            self.evaluator = FleetCostEvaluator(device=dev)
        if self.kernel is None:
            self.kernel = ResidentFleetKernel(device=dev)
        if self.repairer is None:
            self.repairer = BatchedRepairPass(device=dev)
        # one device governs every component the orchestrator owns
        for part in (self.splitter, self.evaluator, self.kernel,
                     self.repairer):
            part.device = dev
        if self.forecaster is not None:
            self.forecaster.to(dev)
        if self.cost_model is None:
            self.cost_model = AnalyticCostModel()
        # one provider governs every pricing surface the orchestrator owns
        # (explicitly-passed components are re-threaded too: the
        # orchestrator's provider is authoritative by contract)
        self.splitter.cost_model = self.cost_model
        self.evaluator.cost_model = self.cost_model
        self.kernel.cost_model = self.cost_model

    # ------------------------------------------------------------------ #
    # shared capacity accounting
    # ------------------------------------------------------------------ #
    def load_table(self, state: SystemState):
        """Per-session induced (node ρ, link ρ, weight bytes) + fleet totals.

        Host-side reference path (O(fleet) Python); the monitoring cycle and
        the simulator use the device-resident totals instead
        (:meth:`resident_table` / :meth:`price_fleet`).
        """
        per = {
            sid: session_induced_loads(s, state)
            for sid, s in self.sessions.items()
        }
        n = state.num_nodes
        tot_node = np.zeros(n)
        tot_link = np.zeros((n, n))
        tot_w = np.zeros(n)
        for node_rho, link_rho, wb in per.values():
            tot_node += node_rho
            tot_link += link_rho
            tot_w += wb
        return per, tot_node, tot_link, tot_w

    def _fold_loads(self, state: SystemState, node, link, wb):
        """Derate capacities by induced load — THE effective-C(t) formula.

        Shared by the scalar :meth:`effective_state` and the fused device
        kernel (arguments broadcast: ``(n,)`` rows or ``(B, n)`` batches), so
        the two can never drift apart.  Returns ``(bg, link_bw, mem)``.
        """
        bg = np.clip(state.background_util + node, 0.0, 0.99)
        bw = state.link_bw * np.clip(1.0 - link, self.bw_floor_frac, 1.0)
        mem = np.maximum(0.0, state.mem_bytes - wb)
        return bg, bw, mem

    def effective_state(
        self,
        state: SystemState,
        *,
        exclude: tuple[int, ...] = (),
        _table=None,
        base: SystemState | None = None,
    ) -> SystemState:
        """C(t) as seen by the excluded sessions: everyone else is load.

        Other sessions' compute joins ``background_util``, their boundary
        traffic derates ``link_bw`` (capped at ``bw_floor_frac`` so a choked
        link stays expensive rather than free), and their resident weights
        shrink ``mem_bytes``.  A ``_table`` built by :meth:`resident_table`
        carries per-session entries only for its ``include`` set; an
        excluded live sid missing from it is filled on demand here (O(K)),
        never silently skipped — skipping would fold the session's own load
        into its residual capacity.

        ``base`` swaps the capacity vectors the fold is applied TO while the
        induced loads stay priced against ``state`` — the forecast-aware
        consumers fold the CURRENT fleet load into the worst-case capacity
        within the horizon (:meth:`forecast_base`), keeping per-session load
        entries consistent with the device-computed totals.
        """
        per, tot_node, tot_link, tot_w = (
            self.load_table(state) if _table is None else _table
        )
        node = tot_node.copy()
        link = tot_link.copy()
        wb = tot_w.copy()
        for sid in exclude:
            if sid not in per and sid in self.sessions:
                per[sid] = session_induced_loads(self.sessions[sid], state)
            if sid in per:
                node -= per[sid][0]
                link -= per[sid][1]
                wb -= per[sid][2]
        eff = (state if base is None else base).copy()
        eff.background_util, eff.link_bw, eff.mem_bytes = self._fold_loads(
            eff, node, link, wb
        )
        return eff

    # ------------------------------------------------------------------ #
    # device-resident fleet state
    # ------------------------------------------------------------------ #
    def _resident(self, layout: dict | None = None) -> FleetStateBuffers:
        """The live buffers, cold-rebuilt only if they ever desync (rows
        placed by ``layout``, a :meth:`FleetStateBuffers.layout`, if given)."""
        buf = self._buffers
        if buf is None or set(buf.row_of) != set(self.sessions):
            stats = None if buf is None else buf.stats
            buf = FleetStateBuffers.from_sessions([
                (sid, (s.graph, s.config.boundaries, s.config.assignment,
                       s.workload, s.source_node, s.input_bytes_per_token))
                for sid, s in self.sessions.items()
            ], device=self.device, layout=layout)
            if stats is not None:  # carry counters across the rebuild
                for k, v in stats.items():
                    buf.stats[k] += v
            self._buffers = buf
            self.full_rebuilds += 1
        return buf

    def invalidate_resident_state(self) -> None:
        """Drop the resident buffers; the next cycle cold-repacks the fleet.

        A journal restore does this (its layout places the rows); otherwise
        it exists for the equivalence tests and a repack-per-cycle A/B mode.
        """
        self._buffers = None

    def _upsert_row(self, sess: FleetSession) -> None:
        if self._buffers is not None:
            self._buffers.upsert(
                sess.sid, sess.graph, sess.config.boundaries,
                sess.config.assignment, sess.workload, sess.source_node,
                sess.input_bytes_per_token,
            )

    def _price(self, buf: FleetStateBuffers, state: SystemState, *,
               now: float | None = None, state_args: tuple | None = None):
        """Every pricing dispatch goes through here so the forecaster (when
        present) rides ALL of them — one compiled program per shape, and the
        ring advances exactly once per sample interval regardless of how
        many dispatches a tick issues (``now=None`` → read-only)."""
        return self.kernel.price(
            buf, state, weights=self.weights, bw_floor=self.bw_floor_frac,
            state_args=state_args, forecaster=self.forecaster, now=now,
        )

    def observed_state(self, state: SystemState | None = None,
                       now: float | None = None) -> SystemState:
        """C(t) as every pricing consumer should see it: profiler output
        (or an explicitly supplied sample) passed through the telemetry
        guard.  The single choke point for degraded-mode handling — the
        monitoring cycle, the per-tick fleet pricing, and admission all
        route here, so one corrupt scrape can't reach the fused kernels
        from any entry."""
        if state is None:
            state = self.profiler.system_state()
        if self.telemetry_guard is not None:
            state = self.telemetry_guard.sanitize(state, now)
        return state

    def forecast_base(self, state: SystemState) -> SystemState:
        """C(t) floored at the worst case within the forecast horizon.

        The admission controller and the scalar re-pricing path fold fleet
        load into THIS state instead of the instantaneous one, so an
        arrival (or a migration candidate) is priced against the minimum
        residual capacity it will actually see over the next H steps.
        Returns ``state`` unchanged when forecasting is off or the predictor
        has not yet observed a full season — reactive behavior, bit-exact.
        """
        fc = self.forecaster
        if fc is None or not fc.ready or fc.bg_wc is None:
            return state
        wc = state.copy()
        wc.background_util = np.clip(fc.bg_wc, 0.0, 0.99)
        # the device kernels carry +BIG for infinite (local) links; restore
        # the host convention so scalar consumers see the same state shape
        wc.link_bw = np.where(np.isinf(state.link_bw), np.inf, fc.bw_wc)
        return wc

    def price_incumbents_with_candidate(
        self,
        graph: ModelGraph,
        sol: Solution,
        workload: Workload,
        *,
        source_node: int = 0,
        input_bytes_per_token: float = 4.0,
        state: SystemState,
        base: SystemState | None = None,
    ) -> tuple[list[int], np.ndarray, np.ndarray]:
        """(sids, latency without, latency with) for every LIVE session,
        re-priced with the candidate placement folded into its effective
        state.

        Admission uses this as the *incumbent guard*: accepting an arrival
        that fits ITS OWN SLO can still bury a long-lived tenant under the
        added contention — the dominant source of chronic SLO breach on the
        saturated fleet (the controller priced newcomers, nobody re-checked
        incumbents).  ``base`` prices against the worst-case capacity within
        the forecast horizon; induced loads always come from the current
        ``state`` (they are raw λ·service, capacity-independent, consistent
        with the device totals).  Event-driven host+device work of
        O(fleet·K) per ARRIVAL — never on the per-cycle hot path.
        """
        graph = self.cost_model.calibrated(graph)
        sids = list(self.sessions)
        if not sids:
            return [], np.zeros(0), np.zeros(0)
        buf = self._resident()
        packed = buf.rows_packed(sids)
        st = state if base is None else base
        node_r, link_r, wb = packed_induced_loads(packed, state)
        tot_n, tot_l, tot_w = node_r.sum(0), link_r.sum(0), wb.sum(0)
        cand = pack_sessions([
            (graph, sol.boundaries, sol.assignment, workload, source_node,
             input_bytes_per_token)
        ])
        cn, cl, cw = packed_induced_loads(cand, state)

        def ev(en, el, ew):
            # per-row effective C(t): THE shared fold formula, broadcast
            # over (B, n) batches (see _fold_loads)
            bg, lbw, mem = self._fold_loads(
                st, (tot_n[None] - node_r) + en,
                (tot_l[None] - link_r) + el, (tot_w[None] - wb) + ew,
            )
            lat, _, _ = self.evaluator.evaluate_batch(
                packed, bg=bg, link_bw=lbw, mem_bytes=mem, state=state,
                weights=self.weights,
            )
            return lat

        return sids, ev(0.0, 0.0, 0.0), ev(cn[0][None], cl[0][None],
                                           cw[0][None])

    def price_fleet(
        self, state: SystemState | None = None, *, now: float | None = None
    ) -> tuple[list[int], np.ndarray, np.ndarray]:
        """(sids, per-session current latency, fleet node-ρ totals) in one
        fused dispatch — each session priced against its own effective C(t).

        This is the read path the simulator uses every tick (replacing the
        per-session Python ``chain_latency`` loop) — only O(B) scalars and
        the (n,) totals come back to host.  ``now`` lets the forecaster
        treat the tick as an observation (sample-interval gated).
        """
        state = self.observed_state(state, now)
        sids = list(self.sessions)
        if not sids:
            return [], np.zeros(0), state.background_util.astype(float).copy()
        buf = self._resident()
        price = self._price(buf, state, now=now)
        rows = torch.as_tensor([buf.row_of[sid] for sid in sids],
                               device=self.device)
        lat, tot_node = to_host(price.lat[rows], price.tot_node)
        return sids, lat, np.clip(
            state.background_util + tot_node, 0.0, None
        )

    def resident_table(
        self, state: SystemState, *, include: tuple[int, ...] = ()
    ):
        """Shared-load table with device-computed totals.

        Same tuple shape as :meth:`load_table` but the per-session entries
        are only materialized (host-side, O(K) each) for ``include`` — the
        sids a caller intends to exclude/re-fold.  Everything else stays on
        device.
        """
        n = state.num_nodes
        if not self.sessions:
            return {}, np.zeros(n), np.zeros((n, n)), np.zeros(n)
        buf = self._resident()
        price = self._price(buf, state)
        per = {
            sid: session_induced_loads(self.sessions[sid], state)
            for sid in include
        }
        return (per, *to_host(price.tot_node, price.tot_link, price.tot_w))

    # ------------------------------------------------------------------ #
    # churn
    # ------------------------------------------------------------------ #
    def admit(
        self,
        graph: ModelGraph,
        workload: Workload,
        *,
        source_node: int = 0,
        arch: str = "",
        now: float = 0.0,
        qos: QoSClass | None = None,
        solution: Solution | None = None,
        prepacked: PackedProblem | None = None,
    ) -> int:
        """Admit a session: solve its split against current fleet load, deploy.

        ``solution`` short-circuits the solve — the admission controller has
        already priced the session against the residual capacity and hands
        the winning (split, placement) over so deployment never re-solves;
        ``prepacked`` likewise hands over the problem tensors packed during
        pricing, so the session's first re-split never re-coarsens either.
        """
        # the admission choke point for calibration: the session LIVES on the
        # calibrated view (resident rows, DP packs, scalar re-prices all see
        # the same graph object; weight bytes are untouched by calibration)
        graph = self.cost_model.calibrated(graph)
        sid = self._next_sid
        self._next_sid += 1
        sess = FleetSession(
            sid=sid, graph=graph, workload=workload, source_node=source_node,
            arch=arch, qos=qos, t_admitted=now,
            throttle=SolveThrottle(self.solve_backoff_s, self.backoff_tol_frac),
            prepacked=prepacked,
        )
        if solution is None:
            state = self.profiler.system_state()
            eff = self.effective_state(state, _table=self.resident_table(state))
            [sol] = self.splitter.solve_batch(
                [self._session_problem(sess)],
                eff, max_units=self.max_units,
            )
            sol = coalesce_same_node(sol)
            sol = local_search(graph, sol, eff, workload,
                               max_rounds=self.local_rounds)
            sol = self.repair_solution(graph, sol, eff, workload,
                                       source_node=source_node)
        else:
            sol = solution
        cfg = self.broadcast.rollout(
            sol.boundaries, sol.assignment,
            reason=f"admit session {sid}" + (f" ({arch})" if arch else ""),
            now=now, session=sid,
        )
        if cfg is None:
            # two-phase deploy aborted (transport faults / fenced zombie
            # epoch): the session never existed — give its sid back so the
            # caller can retry later without burning the id space
            self._next_sid -= 1
            raise AdmissionRolloutError(
                f"admission rollout failed for session {sid}")
        sess.config = cfg
        sess.t_last_reconfig = now
        self.sessions[sid] = sess
        self._upsert_row(sess)
        return sid

    def depart(self, sid: int) -> FleetSession:
        """Remove a session; its induced load vanishes from the shared C(t)."""
        sess = self.sessions.pop(sid)
        if self._buffers is not None and sid in self._buffers.row_of:
            self._buffers.remove(sid)
        return sess

    # ------------------------------------------------------------------ #
    # one monitoring cycle
    # ------------------------------------------------------------------ #
    def _latency(self, sess: FleetSession, sol: Solution, eff: SystemState) -> float:
        return self.cost_model.chain_latency(
            sess.graph, sol.boundaries, sol.assignment, eff, sess.workload
        )

    def _refresh_loads(self, table, sid: int, state: SystemState) -> None:
        """Fold a just-committed session's NEW placement into the shared
        load table so later decisions in the same cycle see it (prevents
        herd migration: two sessions both fleeing to the same idle node)."""
        per, tot_node, tot_link, tot_w = table
        old = per.get(sid)
        new = session_induced_loads(self.sessions[sid], state)
        if old is not None:
            tot_node -= old[0]
            tot_link -= old[1]
            tot_w -= old[2]
        tot_node += new[0]
        tot_link += new[1]
        tot_w += new[2]
        per[sid] = new

    def _session_thresholds(self, sess: FleetSession) -> Thresholds:
        """Per-session Θ: the latency trigger tracks the tenant's QoS SLO."""
        return self.thresholds.for_slo(
            sess.qos.latency_slo_s if sess.qos is not None else None
        )

    def _session_problem(self, sess: FleetSession) -> SessionProblem:
        """The session's joint-DP problem, with its pack cached for life."""
        if sess.prepacked is None:
            sess.prepacked = self.splitter.pack_problem(
                sess.graph, max_units=self.max_units,
                input_bytes_per_token=sess.input_bytes_per_token,
            )
        return SessionProblem(
            sess.graph, sess.workload, source_node=sess.source_node,
            input_bytes_per_token=sess.input_bytes_per_token,
            prepacked=sess.prepacked,
        )

    def _lat_py(self, sess: FleetSession, sol: Solution, state: SystemState,
                table, base: SystemState | None = None) -> float:
        """Scalar re-price against the LIVE table (post-commit freshness);
        ``base`` keeps forecast-priced cycles consistent (loads from the
        table, capacities from the worst case within the horizon)."""
        eff = self.effective_state(
            state, exclude=(sess.sid,), _table=table, base=base
        )
        return self._latency(sess, sol, eff)

    def repair_solution(
        self,
        graph: ModelGraph,
        sol: Solution,
        eff: SystemState,
        workload: Workload,
        *,
        source_node: int = 0,
        input_bytes_per_token: float = 4.0,
    ) -> Solution:
        """Event-driven Eq. 4 repair through the batched device pass.

        A feasible solution returns unchanged without any dispatch; a
        violating one becomes a single-row :class:`BatchedRepairPass` call —
        the same fused program the monitoring cycle runs over the whole
        re-split set — re-priced with the scalar evaluator.  Used by
        deployment (:meth:`admit`) and the admission controller, so
        ``placement.repair_capacity`` stays entirely off the control plane
        (it remains the pinned scalar reference).
        """
        graph = self.cost_model.calibrated(graph)
        if not memory_violations(
            graph, sol.boundaries, sol.assignment, eff
        ).any():
            return sol
        min_k = self._buffers.max_segs if self._buffers is not None else 0
        packed = pack_sessions(
            [(graph, sol.boundaries, sol.assignment, workload, source_node,
              input_bytes_per_token)],
            min_k=min_k,
        )
        [assign] = self.repairer.repair_batch(
            packed,
            bg=np.asarray(eff.background_util, dtype=float)[None],
            link_bw=np.asarray(eff.link_bw, dtype=float)[None],
            mem=np.asarray(eff.mem_bytes, dtype=float)[None],
            state=eff,
        )
        a = tuple(int(x) for x in assign[: len(sol.assignment)])
        return Solution(
            sol.boundaries, a,
            self.cost_model.evaluate(graph, sol.boundaries, a, eff, workload),
        )

    def _mem_feasible(
        self, sess: FleetSession, sol: Solution, state: SystemState, table
    ) -> bool:
        """Commit gate for Eq. 4 (O(K) numpy, no repair on the hot path).

        Candidates arrive already repaired on device against the
        cycle-start residuals; an earlier commit in the same cycle may have
        claimed the memory this candidate counted on, so the gate re-checks
        against the refreshed table.  On violation the session KEEPs its
        (feasible) incumbent config and re-prices next cycle with correct
        residuals — strictly safer than the old Python repair-and-commit.
        """
        eff = self.effective_state(state, exclude=(sess.sid,), _table=table)
        return not memory_violations(
            sess.graph, sol.boundaries, sol.assignment, eff
        ).any()

    def step(self, now: float) -> FleetDecision:
        """One monitoring cycle against the device-resident fleet state.

        Structure (triggers → cool-down → throttle → migrate → batched
        re-split → hysteresis → rollout) is the PR-2 decision skeleton, but
        the per-cycle data flow is inverted: nothing is packed, and the only
        things crossing the device boundary are O(B) trigger scalars — plus,
        on trigger-active cycles, the triggered rows' candidate assignments
        and effective states.  Candidate latencies are priced against the
        cycle-start load picture; a session committing *after* an earlier
        commit in the same cycle is re-priced scalar-side against the
        refreshed host table so two overloaded sessions never chase the same
        idle node (the herd guard).
        """
        t0 = time.perf_counter()
        state = self.observed_state(now=now)
        qnodes: set[int] = (set(self.telemetry_guard.quarantined)
                            if self.telemetry_guard is not None else set())
        # liveness first: the node-fail trigger class is computed from the
        # heartbeat registry, not from C(t) — a node whose capacity traces
        # merely degrade is handled by the ordinary util/bw triggers
        dead_set: set[int] = set()
        storm: set[int] = set()
        if self.heartbeats is not None:
            self.heartbeats.tick()
            # revived nodes need no special handling: their restored
            # capacity re-enters through the profiler's C(t) and the next
            # trigger evaluation sees it — drain so each is reported once
            self.heartbeats.drain_revived()
            dead_set = set(self.heartbeats.dead())
            if dead_set:
                storm = {
                    sid for sid, s in self.sessions.items()
                    if s.config is not None
                    and any(n in dead_set for n in s.config.assignment)
                }
        sids = list(self.sessions)
        per_session: dict[int, Decision] = {}
        if not sids:
            fd = FleetDecision(t=now, per_session={}, solver_time_s=0.0,
                               n_keep=0, n_migrate=0, n_resplit=0,
                               n_cooldown=0, dead_nodes=tuple(sorted(dead_set)))
            self.decisions.append(fd)
            return fd

        # snapshot BEFORE _resident(): a cold rebuild inside this cycle is
        # pack work and must show up in the reported breakdown
        pack0 = (self._buffers.stats["pack_time_s"]
                 if self._buffers is not None else 0.0)
        buf = self._resident()
        t_ev = time.perf_counter()
        state_args = self.kernel.state_args(state)   # one upload per cycle
        price = self._price(buf, state, now=now, state_args=state_args)
        rows = {sid: buf.row_of[sid] for sid in sids}
        rlist = [rows[sid] for sid in sids]
        # forecast-priced env: the SAME scalars under the worst-case
        # capacity within the horizon (equal to the current ones until the
        # predictor has a season of history, or at horizon 0); both groups
        # come to the host in one copy
        use_fc = price.has_forecast
        if use_fc:
            lat_h, util_h, bw_h, latfc_h, utilfc_h, bwfc_h = gather_rows(
                rlist, price.lat, price.max_util, price.min_bw,
                price.lat_fc, price.max_util_fc, price.min_bw_fc
            )
        else:
            lat_h, util_h, bw_h = gather_rows(
                rlist, price.lat, price.max_util, price.min_bw
            )
        eval_t = time.perf_counter() - t_ev
        if (np.isnan(lat_h).any() or np.isnan(util_h).any()
                or np.isnan(bw_h).any()):
            # degraded cycle: the fused price itself is poisoned (telemetry
            # the guard never saw, or the guard is off).  Committing on NaN
            # comparisons would be garbage-in-garbage-out — KEEP every
            # incumbent, leave the trigger EWMAs untouched, and count it.
            self.degraded_cycles += 1
            for i, sid in enumerate(sids):
                sess = self.sessions[sid]
                per_session[sid] = Decision(
                    DecisionKind.KEEP, sess.config, ("degraded-pricing",),
                    float(lat_h[i]), 0.0,
                )
            fd = FleetDecision(
                t=now, per_session=per_session,
                solver_time_s=time.perf_counter() - t0,
                n_keep=len(sids), n_migrate=0, n_resplit=0, n_cooldown=0,
                eval_time_s=eval_t,
                pack_time_s=buf.stats["pack_time_s"] - pack0,
                n_node_fail=len(storm), dead_nodes=tuple(sorted(dead_set)),
            )
            self.decisions.append(fd)
            for sid, d in per_session.items():
                self.sessions[sid].decisions.append(d)
            return fd
        cur_lat = {sid: float(lat_h[i]) for i, sid in enumerate(sids)}
        # candidate-vs-incumbent comparisons run on ONE consistent pricing:
        # forecast worst-case when the forecaster rides, instantaneous else
        cmp_lat = ({sid: float(latfc_h[i]) for i, sid in enumerate(sids)}
                   if use_fc else cur_lat)
        base = self.forecast_base(state) if use_fc else None

        triggered: list[int] = []            # sids, in monitoring order
        proactive: set[int] = set()          # subset raised by the forecast
        reasons_by_sid: dict[int, tuple[str, ...]] = {}
        for i, sid in enumerate(sids):
            sess = self.sessions[sid]
            sess.ewma_latency.update(cur_lat[sid])
            env = TriggerState(
                ewma_latency_s=sess.ewma_latency.get(0.0),
                max_node_util=float(util_h[i]),
                min_link_bw_bps=float(bw_h[i]),
            )
            th = self._session_thresholds(sess)
            if sid in storm:
                # node-fail trigger class: the session's chain crosses a
                # dead node, so its EWMA/cooldown/throttle state — all
                # measured on hardware that no longer exists — is void.
                # Enter the solve set unconditionally.
                triggered.append(sid)
                reasons_by_sid[sid] = tuple(env.reasons) + ("node-fail",)
                continue
            gate = decision_gate(
                env, th, now=now, t_last_reconfig=sess.t_last_reconfig,
                throttle=sess.throttle,
            )
            if (gate == "keep" and qnodes and sess.config is not None
                    and any(n in qnodes for n in sess.config.assignment)):
                # telemetry-quarantine trigger class: the session's chain
                # crosses a node whose measurements are untrusted.  Unlike
                # node-fail the hardware is presumed alive, so the solve is
                # gated by the ordinary cooldown/throttle (no force-commit,
                # no EWMA reset) — it just stops waiting for thresholds
                # computed from telemetry we no longer believe.
                touched = sorted(set(sess.config.assignment) & qnodes)
                envq = TriggerState(
                    ewma_latency_s=env.ewma_latency_s,
                    max_node_util=env.max_node_util,
                    min_link_bw_bps=env.min_link_bw_bps,
                    reasons=[f"telemetry-quarantine: node(s) {touched}"],
                    kinds=("quarantine",),
                )
                gq = decision_gate(
                    envq, th, now=now, t_last_reconfig=sess.t_last_reconfig,
                    throttle=sess.throttle, prefired=True,
                )
                if gq == "solve":
                    env, gate = envq, "solve"
            if gate == "keep" and use_fc:
                # proactive trigger: the observed env is inside Θ but the
                # predicted env within the horizon is not — enter the
                # migrate/re-split set BEFORE the SLO is breached (same
                # cooldown/throttle gating order as decision_gate)
                env_fc = TriggerState(
                    ewma_latency_s=float(latfc_h[i]),
                    max_node_util=float(utilfc_h[i]),
                    min_link_bw_bps=float(bwfc_h[i]),
                )
                if forecast_reconfigure(env_fc, th):
                    env = env_fc
                    gate = decision_gate(
                        env_fc, th, now=now,
                        t_last_reconfig=sess.t_last_reconfig,
                        throttle=sess.throttle, prefired=True,
                    )
                    if gate == "solve":
                        proactive.add(sid)
            if gate == "solve":
                triggered.append(sid)
                reasons_by_sid[sid] = tuple(env.reasons)
                continue
            kind = (DecisionKind.COOLDOWN if gate == "cooldown"
                    else DecisionKind.KEEP)
            reasons = () if gate == "keep" else tuple(env.reasons)
            per_session[sid] = Decision(
                kind, sess.config, reasons, cur_lat[sid], 0.0
            )

        resplit_rows: list[tuple[int, Solution, float]] = []  # (sid, sol, lat)
        infeasible: list[int] = []          # storm-cycle Eq. 4 rejects
        dirty = False                       # any commit this cycle?
        table = None
        fp = None                           # fixed-point dispatch result
        n_conflict = 0                      # conflict KEEPs (see FleetDecision)
        n_nogain = 0                        # hysteresis no-gain KEEPs
        fp_sweeps_run = 0
        fp_aborts = 0
        if triggered and self.use_fixed_point:
            # joint fixed point: ONE device call resolves the
            # whole triggered set — each accepted move was priced against
            # residuals containing every earlier accepted move (red/black
            # sequential consistency), so the host commits the returned
            # rows WITHOUT re-checking hysteresis or Eq. 4 against a table
            # other commits dirtied.  The conflict-KEEP re-check paths of
            # the legacy branch below are retired here.
            t_ev = time.perf_counter()
            trig_m = np.zeros(buf.n_rows, dtype=bool)
            force_m = np.zeros(buf.n_rows, dtype=bool)
            slo_m = np.full(buf.n_rows, self.thresholds.latency_max_s)
            for sid in sids:
                slo_m[rows[sid]] = self._session_thresholds(
                    self.sessions[sid]).latency_max_s
            for sid in triggered:
                trig_m[rows[sid]] = True
                if sid in storm:
                    force_m[rows[sid]] = True
            fp = self.kernel.migrate_fixed_point(
                buf, state, trig=trig_m, force=force_m, slo=slo_m,
                weights=self.weights, bw_floor=self.bw_floor_frac,
                min_improvement_frac=self.min_improvement_frac,
                max_sweeps=self.fixed_point_sweeps, state_args=state_args,
                base_bg=(base.background_util if base is not None else None),
                base_lbw=(base.link_bw if base is not None else None),
            )
            trows = torch.as_tensor([rows[sid] for sid in triggered],
                                    device=self.device)
            (fa_h, fl_h, moved_h, movedpre_h, aborted_h, tot_node_h,
             tot_link_h, tot_w_h) = to_host(
                fp.assign[trows], fp.lat[trows], fp.moved[trows],
                fp.moved_pre[trows], fp.aborted, fp.tot_node, fp.tot_link,
                fp.tot_w,
            )
            fp_sweeps_run = fp.sweeps
            fp_aborts = int(bool(aborted_h))
            eval_t += time.perf_counter() - t_ev
            # the device totals already DESCRIBE the fixed-point assignment,
            # so committed moves need no per-commit table refresh: per-sid
            # entries fill lazily from the (new) configs and stay consistent
            # with these totals.  (A chaos-aborted rollout leaves the totals
            # one move ahead for the rest of this cycle; heals next cycle.)
            table = ({}, tot_node_h, tot_link_h, tot_w_h)
            for pos, sid in enumerate(triggered):
                sess = self.sessions[sid]
                th = self._session_thresholds(sess)
                k = len(sess.config.boundaries) - 1
                f_lat = float(fl_h[pos])
                committed = False
                if moved_h[pos]:
                    # deliberately NOT coalesced: the committed config must
                    # stay bit-identical to the device row, or the post-FP
                    # totals stop describing the fleet (a later re-split
                    # coalesces anyway)
                    mig = Solution(
                        sess.config.boundaries,
                        tuple(int(x) for x in fa_h[pos, :k]), f_lat,
                    )
                    status = self._commit(
                        sid, mig, f_lat, cmp_lat[sid], DecisionKind.MIGRATE,
                        reasons_by_sid[sid], per_session, now,
                        force=sid in storm, pregated=True,
                    )
                    committed = status == "committed"
                if f_lat > th.latency_max_s:
                    # the joint fixed point still breaches this row's SLO:
                    # escalate to the batched re-split, comparing against
                    # the (possibly just-committed) incumbent
                    resplit_rows.append((sid, Solution(
                        sess.config.boundaries, sess.config.assignment, 0.0,
                    ), f_lat))
                    if not committed:
                        per_session[sid] = Decision(
                            DecisionKind.RESPLIT, sess.config,
                            reasons_by_sid[sid], f_lat, 0.0,
                        )
                    continue
                if not moved_h[pos]:
                    if movedpre_h[pos]:
                        # the joint Eq. 4 guard reverted this row's accepted
                        # move — the fixed-point flavour of a conflict KEEP
                        n_conflict += 1
                        tag = ("conflict-keep", "fixed-point-abort")
                        if dead_set:
                            infeasible.append(sid)
                    else:
                        n_nogain += 1
                        tag = ("no-gain-keep",)
                    per_session[sid] = Decision(
                        DecisionKind.KEEP, sess.config,
                        reasons_by_sid[sid] + tag, f_lat, 0.0,
                    )
        elif triggered:
            t_ev = time.perf_counter()
            assign_d, mig_lat_d, mig_cost_d = self.kernel.migrate(
                buf, price, state, weights=self.weights,
                state_args=state_args, use_forecast=use_fc,
            )
            trows = torch.as_tensor([rows[sid] for sid in triggered],
                                    device=self.device)
            (assign_h, mig_lat_h, mig_cost_h, segw_t, valid_t, mem_t,
             tot_node_h, tot_link_h, tot_w_h) = to_host(
                assign_d[trows], mig_lat_d[trows], mig_cost_d[trows],
                buf.seg_wbytes[trows], buf.valid[trows], price.mem[trows],
                price.tot_node, price.tot_link, price.tot_w,
            )
            eval_t += time.perf_counter() - t_ev
            # commit gate, vectorized: ONE Eq. 4 check over every triggered
            # candidate against its cycle-start residuals (the per-session
            # effective-state rebuild only runs after a commit dirtied them)
            over_t = memory_violations_packed(segw_t, assign_h, valid_t, mem_t)
            mig_feasible = {
                sid: not over_t[pos].any()
                for pos, sid in enumerate(triggered)
            }
            # host load table with device-computed totals; per-session
            # entries are filled lazily by effective_state for the sids it
            # actually excludes (re-split set, post-commit re-pricing)
            table = ({}, tot_node_h, tot_link_h, tot_w_h)
            for pos, sid in enumerate(triggered):
                sess = self.sessions[sid]
                th = self._session_thresholds(sess)
                k = len(sess.config.boundaries) - 1
                mig = coalesce_same_node(Solution(
                    sess.config.boundaries,
                    tuple(int(x) for x in assign_h[pos, :k]),
                    float(mig_cost_h[pos]),
                ))
                if mig_lat_h[pos] > th.latency_max_s:
                    resplit_rows.append((sid, mig, float(mig_lat_h[pos])))
                    per_session[sid] = Decision(
                        DecisionKind.RESPLIT, sess.config, reasons_by_sid[sid],
                        float(mig_lat_h[pos]), 0.0,
                    )
                    continue
                c_lat, m_lat = cmp_lat[sid], float(mig_lat_h[pos])
                if dirty:  # re-price against the post-commit table
                    c_lat = self._lat_py(
                        sess, Solution(sess.config.boundaries,
                                       sess.config.assignment, 0.0),
                        state, table, base,
                    )
                    m_lat = self._lat_py(sess, mig, state, table, base)
                # device-repaired against cycle-start residuals; the gate
                # only re-checks vs memory claimed by earlier commits
                feasible = (self._mem_feasible(sess, mig, state, table)
                            if dirty else mig_feasible[sid])
                if not feasible:
                    # record the KEPT incumbent's latency, not the price of
                    # the candidate just rejected.  A dirtied-residual reject
                    # is a CONFLICT (an earlier commit claimed the memory);
                    # a cycle-start reject is plain Eq. 4 infeasibility.
                    if dirty:
                        n_conflict += 1
                        tag = ("conflict-keep",)
                    else:
                        tag = ("infeasible-keep",)
                    per_session[sid] = Decision(
                        DecisionKind.KEEP, sess.config,
                        reasons_by_sid[sid] + tag, c_lat, 0.0,
                    )
                    if dead_set:
                        infeasible.append(sid)
                    continue
                # capture the OLD config's loads before _commit overwrites
                # it: _refresh_loads subtracts this entry from the shared
                # totals, and the lazy table may not hold it yet
                if sid not in table[0]:
                    table[0][sid] = session_induced_loads(sess, state)
                status = self._commit(
                    sid, mig, m_lat, c_lat, DecisionKind.MIGRATE,
                    reasons_by_sid[sid], per_session, now, force=sid in storm,
                )
                if status == "committed":
                    self._refresh_loads(table, sid, state)
                    dirty = True
                elif status == "keep-no-gain":
                    n_nogain += 1

        # batched full re-split (Eq. 8): ONE batched DP for the failing set
        if resplit_rows:
            exclude = tuple(sid for sid, *_ in resplit_rows)
            solve_state = self.effective_state(
                state, exclude=exclude, _table=table, base=base
            )
            problems = [
                self._session_problem(self.sessions[sid])
                for sid, *_ in resplit_rows
            ]
            sols = self.splitter.solve_batch(
                problems, solve_state, max_units=self.max_units
            )
            rs_sols = [coalesce_same_node(rs) for rs in sols]
            rs_items = [
                (self.sessions[sid].graph, rs.boundaries, rs.assignment,
                 self.sessions[sid].workload, self.sessions[sid].source_node,
                 self.sessions[sid].input_bytes_per_token)
                for (sid, *_), rs in zip(resplit_rows, rs_sols)
            ]
            rrows = [rows[sid] for sid, *_ in resplit_rows]
            if fp is not None:
                # fixed-point cycles price the escalated re-splits against
                # the CONVERGED effective rows — the residual surface after
                # every accepted move, not the cycle-start one
                bg_h, lbw_h, mem_h = gather_rows(
                    rrows, fp.bg, fp.link_bw, fp.mem,
                )
            else:
                # forecast cycles price re-split candidates against the same
                # worst-case effective rows the migrate kernel used
                bg_h, lbw_h, mem_h = gather_rows(
                    rrows,
                    price.bg_fc if use_fc else price.bg,
                    price.lbw_fc if use_fc else price.link_bw,
                    price.mem,
                )
            packed_rs = pack_sessions(rs_items, min_k=buf.max_segs)
            # Eq. 4 over the WHOLE re-split set at once: one vectorized
            # check, and — only when something violates — ONE fused
            # repair-and-price dispatch (no per-session Python Φ loops, no
            # second pricing round-trip on the hot path)
            over_rs = memory_violations_packed(
                packed_rs.seg_wbytes, packed_rs.seg_node, packed_rs.valid,
                mem_h,
            )
            t_ev = time.perf_counter()
            if over_rs.any():
                rep_a, rs_lat = self.repairer.repair_and_price_batch(
                    packed_rs, bg=bg_h, link_bw=lbw_h, mem=mem_h,
                    state=state, weights=self.weights,
                )
                # a repaired row's DP surrogate cost no longer describes its
                # assignment — carry the repaired candidate's latency instead
                new_sols = []
                for i, rs in enumerate(rs_sols):
                    na = tuple(int(x) for x in rep_a[i, : len(rs.assignment)])
                    cost = rs.cost if na == rs.assignment else float(rs_lat[i])
                    new_sols.append(Solution(rs.boundaries, na, cost))
                rs_sols = new_sols
                over_rs = memory_violations_packed(
                    packed_rs.seg_wbytes, rep_a, packed_rs.valid, mem_h,
                )
            else:
                rs_lat, _, _ = self.evaluator.evaluate_batch(
                    packed_rs, bg=bg_h, link_bw=lbw_h, mem_bytes=mem_h,
                    state=state, weights=self.weights,
                )
            eval_t += time.perf_counter() - t_ev
            if fp is not None:
                # fixed-point escalation: the incumbent already IS the best
                # joint-feasible row (committed or kept above); accept the
                # re-split only if it improves on it, with one single-row
                # repair retry against the live residuals before conceding
                # a conflict-KEEP
                for pos, (sid, cur_sol, f_lat) in enumerate(resplit_rows):
                    sess = self.sessions[sid]
                    rs, r_lat = rs_sols[pos], float(rs_lat[pos])
                    c_lat = f_lat
                    if dirty:
                        r_lat = self._lat_py(sess, rs, state, table, base)
                        c_lat = self._lat_py(sess, cur_sol, state, table, base)
                    feasible = (self._mem_feasible(sess, rs, state, table)
                                if dirty else not over_rs[pos].any())
                    if not feasible and dirty:
                        # a dirtied reject never stands on a stale price:
                        # first a single-row repair of the batch candidate
                        # against the LIVE residuals, then — if that still
                        # violates — a fresh single-row re-solve.  Whatever
                        # is gated below was priced against the residuals
                        # it commits into, so the stale-price conflict-KEEP
                        # of the legacy path is structurally gone here.
                        # (Clean-table rejects skip the rescue: the batch
                        # candidate was already repaired against the
                        # CONVERGED fixed-point residuals in one fused
                        # dispatch, so a violation there is plain Eq. 4
                        # infeasibility — re-solving per row would pay B
                        # host round-trips per cycle in saturated overload
                        # for candidates that cannot become feasible.)
                        eff = self.effective_state(
                            state, exclude=(sid,), _table=table, base=base,
                        )
                        rs2 = self.repair_solution(
                            sess.graph, rs, eff, sess.workload,
                            source_node=sess.source_node,
                            input_bytes_per_token=sess.input_bytes_per_token,
                        )
                        if rs2.assignment == rs.assignment or \
                                not self._mem_feasible(sess, rs2, state,
                                                       table):
                            [rs2] = self.splitter.solve_batch(
                                [self._session_problem(sess)], eff,
                                max_units=self.max_units,
                            )
                            rs2 = coalesce_same_node(rs2)
                            rs2 = self.repair_solution(
                                sess.graph, rs2, eff, sess.workload,
                                source_node=sess.source_node,
                                input_bytes_per_token=(
                                    sess.input_bytes_per_token),
                            )
                        if self._mem_feasible(sess, rs2, state, table):
                            rs = rs2
                            r_lat = self._lat_py(sess, rs, state, table, base)
                            feasible = True
                    if not feasible:
                        # irreparable even after the repair retry AND a
                        # fresh re-solve against the LIVE residuals: no
                        # feasible split exists for this row in the current
                        # fleet state.  That is plain Eq. 4 infeasibility —
                        # never a conflict-KEEP, because nothing gated here
                        # was priced against residuals a sibling commit
                        # dirtied (the rescue above re-priced it live).
                        tag = ("infeasible-keep",)
                        prior = per_session.get(sid)
                        if (prior is None
                                or prior.kind is not DecisionKind.MIGRATE):
                            per_session[sid] = Decision(
                                DecisionKind.KEEP, sess.config,
                                reasons_by_sid[sid] + tag, c_lat, 0.0,
                            )
                        if dead_set:
                            infeasible.append(sid)
                        continue
                    if sid not in table[0]:
                        table[0][sid] = session_induced_loads(sess, state)
                    prior = per_session.get(sid)
                    status = self._commit(
                        sid, rs, r_lat, c_lat, DecisionKind.RESPLIT,
                        reasons_by_sid[sid], per_session, now,
                        force=sid in storm,
                    )
                    if status == "committed":
                        self._refresh_loads(table, sid, state)
                        dirty = True
                    elif (prior is not None
                          and prior.kind is DecisionKind.MIGRATE):
                        # the fixed-point MIGRATE committed above stands;
                        # a failed refinement must not downgrade the
                        # recorded decision to KEEP
                        per_session[sid] = prior
                    elif status == "keep-no-gain":
                        n_nogain += 1
                resplit_rows = []
            for pos, (sid, mig, m_lat) in enumerate(resplit_rows):
                sess = self.sessions[sid]
                rs, r_lat = rs_sols[pos], float(rs_lat[pos])
                c_lat = cmp_lat[sid]
                if dirty:
                    # earlier commits this cycle moved the cost surface:
                    # re-price BOTH candidates (and the incumbent) against
                    # the refreshed table so the migrate-vs-resplit choice
                    # is not biased toward a stale price
                    m_lat = self._lat_py(sess, mig, state, table, base)
                    r_lat = self._lat_py(sess, rs, state, table, base)
                    c_lat = self._lat_py(
                        sess, Solution(sess.config.boundaries,
                                       sess.config.assignment, 0.0),
                        state, table, base,
                    )
                kind, chosen, chosen_lat = DecisionKind.RESPLIT, rs, r_lat
                if m_lat < r_lat:
                    kind, chosen, chosen_lat = DecisionKind.MIGRATE, mig, m_lat
                # both candidates were batch-repaired against cycle-start
                # residuals; the vectorized gate applies until an earlier
                # commit dirties the residuals this cycle
                if dirty:
                    feasible = self._mem_feasible(sess, chosen, state, table)
                elif kind is DecisionKind.MIGRATE:
                    feasible = mig_feasible[sid]
                else:
                    feasible = not over_rs[pos].any()
                if not feasible:
                    # as in the migrate branch: the KEEP records the kept
                    # incumbent's latency, tagged by WHY it was rejected
                    if dirty:
                        n_conflict += 1
                        tag = ("conflict-keep",)
                    else:
                        tag = ("infeasible-keep",)
                    per_session[sid] = Decision(
                        DecisionKind.KEEP, sess.config,
                        reasons_by_sid[sid] + tag, c_lat, 0.0,
                    )
                    if dead_set:
                        infeasible.append(sid)
                    continue
                # old-config loads must be in the table before the commit
                # replaces the config (see the migrate branch above)
                if sid not in table[0]:
                    table[0][sid] = session_induced_loads(sess, state)
                status = self._commit(
                    sid, chosen, chosen_lat, c_lat, kind,
                    reasons_by_sid[sid], per_session, now, force=sid in storm,
                )
                if status == "committed":
                    self._refresh_loads(table, sid, state)
                    dirty = True
                elif status == "keep-no-gain":
                    n_nogain += 1

        solver_time = time.perf_counter() - t0
        if dead_set:
            # a storm session whose forced solve still left it on a dead
            # node (the DP found no escape) is infeasible even though its
            # decision reads KEEP-of-identical-config
            stuck = {
                sid for sid in storm
                if sid in self.sessions and any(
                    n in dead_set
                    for n in self.sessions[sid].config.assignment
                )
            }
            infeasible = sorted(set(infeasible) | stuck)
        kinds = [d.kind for d in per_session.values()]
        fd = FleetDecision(
            t=now,
            per_session=per_session,
            solver_time_s=solver_time,
            n_keep=sum(k == DecisionKind.KEEP for k in kinds),
            n_migrate=sum(k == DecisionKind.MIGRATE for k in kinds),
            n_resplit=sum(k == DecisionKind.RESPLIT for k in kinds),
            n_cooldown=sum(k == DecisionKind.COOLDOWN for k in kinds),
            eval_time_s=eval_t,
            pack_time_s=buf.stats["pack_time_s"] - pack0,
            n_preempt=sum(
                1 for sid, d in per_session.items()
                if sid in proactive
                and d.kind in (DecisionKind.MIGRATE, DecisionKind.RESPLIT)
            ),
            n_node_fail=len(storm),
            dead_nodes=tuple(sorted(dead_set)),
            infeasible_sids=tuple(infeasible),
            n_conflict_keep=n_conflict,
            n_nogain_keep=n_nogain,
            fixed_point_sweeps=fp_sweeps_run,
            fixed_point_aborts=fp_aborts,
        )
        self.decisions.append(fd)
        for sid, d in per_session.items():
            self.sessions[sid].decisions.append(d)
        return fd

    # ------------------------------------------------------------------ #
    def _commit(
        self,
        sid: int,
        chosen: Solution,
        chosen_lat: float,
        cur_lat: float,
        kind: DecisionKind,
        reasons: tuple[str, ...],
        per_session: dict[int, Decision],
        now: float,
        force: bool = False,
        pregated: bool = False,
    ) -> str:
        """Hysteresis + two-phase rollout; KEEP on no-gain or abort.

        Returns a commit status: ``"committed"`` iff a new config was
        actually rolled out (callers then refresh the shared load table for
        the rest of the cycle; the session's resident-buffer row is updated
        here), else one of ``"keep-same"`` (identical config),
        ``"keep-no-gain"`` (hysteresis rejected the candidate — the
        ordinary anti-thrash KEEP), or ``"keep-abort"`` (the two-phase
        rollout itself aborted).  The split lets :meth:`step` count no-gain
        KEEPs separately from conflict KEEPs.

        SLO rescue: the anti-thrash hysteresis demands a material
        (``min_improvement_frac``) gain before paying for a rollout — but a
        session sitting marginally OVER its hard SLO whose best candidate
        clears it may never find a 10% improvement, and would breach for
        the rest of its lifetime.  Crossing back under the SLO is material
        by definition, so that case bypasses the improvement threshold
        (identical configs still KEEP).

        ``force`` (the node-fail trigger class) skips the improvement
        threshold entirely: any DIFFERENT config beats one touching a dead
        node, whatever its price — both latencies were measured on a
        topology that no longer exists.  A committed forced move also
        resets the session's latency EWMA for the same reason.

        ``pregated`` (the fixed-point path) also skips the improvement
        threshold — the device accept predicate already applied it inside
        the red/black loop, against fresher residuals than the host has —
        but does NOT reset the EWMA: the hardware the session measured is
        still alive.
        """
        sess = self.sessions[sid]
        same = ((chosen.boundaries, chosen.assignment)
                == (sess.config.boundaries, sess.config.assignment))
        keep = hysteresis_keep(
            (sess.config.boundaries, sess.config.assignment),
            (chosen.boundaries, chosen.assignment),
            chosen_lat, cur_lat, self.min_improvement_frac,
        )
        if force or pregated:
            keep = same
        elif keep:
            slo = self._session_thresholds(sess).latency_max_s
            if not same and cur_lat > slo >= chosen_lat:
                keep = False
        if keep:
            status = "keep-same" if same else "keep-no-gain"
            tag = () if same else ("no-gain-keep",)
            per_session[sid] = Decision(
                DecisionKind.KEEP, sess.config, reasons + tag, chosen_lat,
                0.0,
            )
            return status
        cfg = self.broadcast.rollout(
            chosen.boundaries, chosen.assignment,
            reason=f"session {sid}: " + "; ".join(reasons), now=now,
            session=sid,
        )
        if cfg is None:  # rollout aborted — keep serving the old config
            per_session[sid] = Decision(
                DecisionKind.KEEP, sess.config,
                reasons + ("rollout-abort",), chosen_lat, 0.0,
            )
            return "keep-abort"
        sess.config = cfg
        sess.t_last_reconfig = now
        if force:
            sess.ewma_latency = EWMA(sess.ewma_latency.alpha)
        per_session[sid] = Decision(kind, cfg, reasons, chosen_lat, 0.0)
        self._upsert_row(sess)
        return "committed"

    # ------------------------------------------------------------------ #
    # crash-recoverable control plane
    # ------------------------------------------------------------------ #
    # ``state_dict``/``save``/``load`` snapshot all control-plane state that
    # affects future decisions.  The device-resident buffers are not
    # serialized: a cold ``_resident()`` rebuild gives the same rows as the
    # incremental updates.  Their placement is: after churn, the incremental
    # rows sit where freed slots were reused, and row order decides the
    # fixed point's red/black colours and the order the fleet totals sum in.
    # So the journal carries ``FleetStateBuffers.layout()`` (host integers)
    # beside the reference's format, as extra ``resident__*`` arrays that
    # the reference ignores; a journal without them (the reference's)
    # rebuilds densely in session order, as the reference does.  Forecast
    # rings leave the device through the forecaster's own ``state_dict``
    # (host numpy) and return to THIS orchestrator's device through its
    # ``load_state_dict``, so a journal written on the card loads on the
    # CPU and the other way round.

    def state_dict(self, *, admission=None) -> dict:
        """Plain-data snapshot: ``{"meta": json-able, "forecast": arrays,
        "resident": arrays}`` (``meta`` and ``forecast`` as the reference's).

        ``admission`` (a :class:`~repro_torch.core.admission.
        FleetAdmissionController`) folds the defer queue and counters into
        the same snapshot, so a restart while requests wait loses none.
        """
        sessions = []
        for sid, s in self.sessions.items():
            sessions.append({
                "sid": sid,
                "graph": _graph_to_dict(s.graph),
                "workload": _workload_to_dict(s.workload),
                "source_node": s.source_node,
                "arch": s.arch,
                "input_bytes_per_token": s.input_bytes_per_token,
                "qos": _qos_to_dict(s.qos),
                "config": _config_to_dict(s.config),
                "ewma": _ewma_to_list(s.ewma_latency),
                "t_admitted": s.t_admitted,
                "t_last_reconfig": s.t_last_reconfig,
                "throttle": {
                    "backoff_s": s.throttle.backoff_s,
                    "tol_frac": s.throttle.tol_frac,
                    "t_last": s.throttle.t_last,
                    "kinds": list(s.throttle.kinds),
                    "ewma": s.throttle.ewma,
                },
            })
        p = self.profiler
        meta: dict = {
            "schema": JOURNAL_SCHEMA,
            "next_sid": self._next_sid,
            "degraded_cycles": self.degraded_cycles,
            "sessions": sessions,
            "broadcast": {"version": self.broadcast._version,
                          "epoch": self.broadcast.epoch},
            "profiler": {
                "ewma_alpha": p.ewma_alpha,
                "base_state": _state_to_dict(p.base_state),
                "util": {str(n): _ewma_to_list(e)
                         for n, e in p._util.items()},
                "util_total": {str(n): _ewma_to_list(e)
                               for n, e in p._util_total.items()},
                "lat": _ewma_to_list(p._lat),
                "link_bw": (None if p._link_bw is None
                            else np.asarray(p._link_bw,
                                            dtype=np.float64).tolist()),
            },
            "heartbeats": None,
            "guard": (None if self.telemetry_guard is None
                      else self.telemetry_guard.state_dict()),
            "admission": None if admission is None else admission.state_dict(),
        }
        hb = self.heartbeats
        if hb is not None:
            meta["heartbeats"] = {
                "nodes": list(hb.nodes),
                "miss_limit": hb.miss_limit,
                "last_beat": {str(n): t for n, t in hb._last_beat.items()},
                "dead": sorted(hb._dead),
                "revived": list(hb._revived),
                "tick": hb._tick,
            }
        fc = self.forecaster.state_dict() if self.forecaster is not None else {}
        buf = self._buffers
        resident = (buf.layout() if buf is not None
                    and set(buf.row_of) == set(self.sessions) else {})
        return {"meta": meta, "forecast": fc, "resident": resident}

    def load_state_dict(self, sd: dict, *, admission=None,
                        claim_epoch: bool = True,
                        reseed_agents: bool = False) -> None:
        """Restore a :meth:`state_dict` snapshot into this orchestrator.

        Call on a freshly constructed orchestrator wired to the surviving
        data plane (the broadcast agents keep their committed configs across
        a *controller* crash).  ``claim_epoch`` fences the pre-crash zombie:
        the restored controller bumps every agent's epoch, so any in-flight
        rollout from the dead controller is rejected at prepare.
        ``reseed_agents`` also re-stamps each session's active config onto
        its agents — for drills where the data plane restarted too.
        """
        meta = sd["meta"]
        if meta.get("schema") != JOURNAL_SCHEMA:
            raise ValueError(f"unknown journal schema {meta.get('schema')!r}")
        self.sessions.clear()
        for e in meta["sessions"]:
            thr = e["throttle"]
            sess = FleetSession(
                sid=int(e["sid"]),
                graph=_graph_from_dict(e["graph"]),
                workload=Workload(**e["workload"]),
                source_node=int(e["source_node"]),
                arch=e["arch"],
                input_bytes_per_token=float(e["input_bytes_per_token"]),
                qos=_qos_from_dict(e["qos"]),
                config=_config_from_dict(e["config"]),
                ewma_latency=_ewma_from_list(e["ewma"]),
                t_admitted=float(e["t_admitted"]),
                t_last_reconfig=float(e["t_last_reconfig"]),
                throttle=SolveThrottle(
                    backoff_s=float(thr["backoff_s"]),
                    tol_frac=float(thr["tol_frac"]),
                    t_last=float(thr["t_last"]),
                    kinds=tuple(thr["kinds"]),
                    ewma=float(thr["ewma"]),
                ),
            )
            self.sessions[sess.sid] = sess
        self._next_sid = int(meta["next_sid"])
        self.degraded_cycles = int(meta["degraded_cycles"])
        self.broadcast._version = int(meta["broadcast"]["version"])
        self.broadcast.epoch = int(meta["broadcast"]["epoch"])
        # profiler EWMAs feed every future C(t): restore in place
        pm = meta["profiler"]
        p = self.profiler
        p.ewma_alpha = float(pm["ewma_alpha"])
        p.base_state = _state_from_dict(pm["base_state"])
        p._util = {int(n): _ewma_from_list(v) for n, v in pm["util"].items()}
        p._util_total = {int(n): _ewma_from_list(v)
                         for n, v in pm["util_total"].items()}
        p._lat = _ewma_from_list(pm["lat"])
        p._link_bw = (None if pm["link_bw"] is None
                      else np.asarray(pm["link_bw"], dtype=np.float64))
        if meta["heartbeats"] is not None:
            hm = meta["heartbeats"]
            hb = HeartbeatRegistry(nodes=list(hm["nodes"]),
                                   miss_limit=int(hm["miss_limit"]))
            hb._last_beat = {int(n): int(t)
                             for n, t in hm["last_beat"].items()}
            hb._dead = set(hm["dead"])
            hb._revived = list(hm["revived"])
            hb._tick = int(hm["tick"])
            self.heartbeats = hb
        else:
            self.heartbeats = None
        if meta["guard"] is not None:
            if self.telemetry_guard is None:
                self.telemetry_guard = TelemetryGuard()
            self.telemetry_guard.load_state_dict(meta["guard"])
        else:
            self.telemetry_guard = None
        fc = sd.get("forecast") or {}
        if fc:
            if self.forecaster is None:
                raise ValueError(
                    "journal carries forecast state but this orchestrator "
                    "has no forecaster — construct it with the same "
                    "ForecastConfig before loading")
            self.forecaster.load_state_dict(fc)
        if admission is not None and meta["admission"] is not None:
            admission.load_state_dict(meta["admission"])
        if reseed_agents:
            for sid, sess in self.sessions.items():
                if sess.config is None:
                    continue
                hosting = set(sess.config.assignment)
                for a in self.broadcast.agents:
                    inner = _unwrap(a)
                    if inner.node_id in hosting:
                        inner.active_by[sid] = sess.config
        if claim_epoch:
            self.broadcast.claim_epoch()
        self.decisions.clear()
        self.invalidate_resident_state()
        if sd.get("resident"):
            # rows back where the journal placed them, before any churn
            self._resident(layout=sd["resident"])

    def save(self, path, *, admission=None) -> None:
        """Atomically persist :meth:`state_dict` as one ``.npz`` journal.

        Written to a temporary file in the destination directory, then
        ``os.replace``d: a crash mid-save leaves the previous journal intact,
        never a torn one.
        """
        sd = self.state_dict(admission=admission)
        blob = json.dumps(sd["meta"]).encode("utf-8")
        arrays: dict[str, np.ndarray] = {
            "meta": np.frombuffer(blob, dtype=np.uint8)
        }
        for k, v in sd["forecast"].items():
            arrays[f"fc__{k}"] = np.asarray(v)
        for k, v in sd["resident"].items():
            arrays[f"resident__{k}"] = np.asarray(v)
        path = os.fspath(path)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".", suffix=".journal.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, path, *, admission=None, claim_epoch: bool = True,
             reseed_agents: bool = False) -> None:
        """Restore a :meth:`save` journal (see :meth:`load_state_dict`)."""
        with np.load(os.fspath(path), allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
            fc = {k[4:]: np.array(z[k]) for k in z.files
                  if k.startswith("fc__")}
            resident = {k[10:]: np.array(z[k]) for k in z.files
                        if k.startswith("resident__")}
        self.load_state_dict({"meta": meta, "forecast": fc,
                              "resident": resident},
                             admission=admission, claim_epoch=claim_epoch,
                             reseed_agents=reseed_agents)


# --------------------------------------------------------------------------- #
# region-sharded fleet orchestration
# --------------------------------------------------------------------------- #
# sid namespace stride per region: sids stay globally unique without any
# cross-region coordination, and a migrated session KEEPS its sid (the
# target region admits it with _next_sid temporarily pinned to the old id)
_REGION_SID_BASE = 1 << 24


class _ShardedProfiler:
    """Profiler facade over one :class:`CapacityProfiler` per region.

    The fleet simulator talks to ONE profiler (``base_state`` per tick,
    ``observe_*`` streams); the sharded control plane needs each region's
    orchestrator to see only its own 4-node slice.  This facade keeps the
    global C(t) and routes every write to the owning region in local
    coordinates, so the per-region orchestrators/admission controllers are
    completely unaware they are shards.
    """

    def __init__(self, wrapper: "ShardedFleetOrchestrator") -> None:
        self._w = wrapper

    @property
    def ewma_alpha(self) -> float:
        return self._w.inners[0].profiler.ewma_alpha

    @property
    def base_state(self) -> SystemState:
        return self._w._global_base

    @base_state.setter
    def base_state(self, st: SystemState) -> None:
        self._w._global_base = st
        for r, o in enumerate(self._w.inners):
            o.profiler.base_state = region_slice(st, self._w.node_ix[r])

    def observe_node(self, s) -> None:
        r, local = self._w.locate_node(s.node)
        self._w.inners[r].profiler.observe_node(_dc_replace(s, node=local))

    def observe_links(self, bw_matrix_bps: np.ndarray) -> None:
        for r, o in enumerate(self._w.inners):
            ix = self._w.node_ix[r]
            o.profiler.observe_links(bw_matrix_bps[np.ix_(ix, ix)])

    def observe_latency(self, e2e_latency_s: float) -> None:
        for o in self._w.inners:
            o.profiler.observe_latency(e2e_latency_s)

    def system_state(self) -> SystemState:
        """Global C(t) re-assembled from the per-region profiler views."""
        st = self._w._global_base.copy()
        for r, o in enumerate(self._w.inners):
            ix = self._w.node_ix[r]
            local = o.profiler.system_state()
            st.background_util[ix] = local.background_util
            st.link_bw[np.ix_(ix, ix)] = local.link_bw
        return st


class ShardedFleetOrchestrator:
    """Region-sharded Adaptive Split Orchestration.

    One :class:`FleetOrchestrator` per MEC region, each owning its own
    resident :class:`~repro_torch.core.fleet_eval.FleetStateBuffers` + kernel over
    the region-local C(t).  Sessions are placed on their own region's nodes
    only, so the fleet decomposes block-diagonally: per-region pricing and
    the per-region fixed point are *exact*, and the cross-region
    coupling reduces to a cheap host-side aggregator that nominates top-k
    breach-seconds rows for migration into the region with the most
    residual headroom (priced through the target's existing B=1
    solve/repair path — no new device machinery).

    A monitoring cycle is: ONE vmapped cross-shard screen call
    (:meth:`~repro_torch.core.fleet_eval.ShardedFleetState.screen`) pricing every
    shard against its regional C(t), a vectorized host-side trigger check
    per shard, full :meth:`FleetOrchestrator.step` cycles ONLY for shards
    showing trigger activity (quiet shards advance their sessions' EWMAs
    vectorized and KEEP everything — the screen predicate mirrors
    ``triggers.should_reconfigure`` exactly, and cooldown/throttle gates
    only ever *suppress* solves, so skipping a quiet shard's step changes
    nothing it would have done), then the cross-region aggregator.  Cycle
    cost therefore grows ~O(triggered set), not O(fleet).

    ``n_regions == 1`` delegates EVERY operation verbatim to the single
    inner orchestrator — bit-identical to the unsharded path by
    construction (test-enforced).

    Quiet-shard bookkeeping note: a skipped shard's per-session
    ``FleetSession.ewma_latency`` objects are allowed to go stale — the
    wrapper's per-row EWMA arrays are authoritative and are written back
    into the session objects immediately before that shard's next real
    ``step`` (and merged decisions count those sessions as KEEPs without
    materializing per-session ``Decision`` objects).
    """

    def __init__(self, inners, *, region_of: np.ndarray,
                 cross_top_k: int = 4,
                 cross_margin: float = 0.05) -> None:
        self.inners = list(inners)
        S = len(self.inners)
        region_of = np.asarray(region_of, dtype=np.int64)
        if region_of.max() + 1 != S:
            raise ValueError(
                f"region_of names {int(region_of.max()) + 1} regions "
                f"for {S} inner orchestrators")
        self.region_of_node = region_of
        # global node ids per region + inverse map (global -> (r, local))
        self.node_ix = [np.where(region_of == r)[0] for r in range(S)]
        self._local_of = {
            int(g): (r, i)
            for r in range(S)
            for i, g in enumerate(self.node_ix[r])
        }
        for r, o in enumerate(self.inners):
            n_local = o.profiler.base_state.num_nodes
            if n_local != len(self.node_ix[r]):
                raise ValueError(
                    f"region {r}: orchestrator has {n_local} nodes, "
                    f"region_of assigns {len(self.node_ix[r])}")
            if S > 1:
                o._next_sid = r * _REGION_SID_BASE
        # how many breach rows the aggregator prices per cycle, and the
        # minimum headroom advantage (in peak node rho) a target region must
        # hold over the source before a cross-region move is even priced
        self.cross_top_k = int(cross_top_k)
        self.cross_margin = float(cross_margin)
        self.cross_migrations = 0
        self.cross_rejected = 0
        # placeholder buffers on the inners' device: every cycle swaps in
        # the live ones (_sharded)
        self._shstate = ShardedFleetState(
            [FleetStateBuffers(rows=1, segs=1, device=o.device)
             for o in self.inners],
            [o.kernel for o in self.inners],
        ) if S > 1 else None
        # per-shard row-indexed tracking (rebuilt on buffer signature change):
        # EWMA latency (NaN = uninitialized), per-row SLO, row -> sid
        self._ewma = [np.zeros(0) for _ in range(S)]
        self._slo = [np.zeros(0) for _ in range(S)]
        self._sid_at = [np.zeros(0, dtype=np.int64) for _ in range(S)]
        self._track_sig = [None] * S
        self._decisions: list[FleetDecision] = []
        self._global_base = None
        self.profiler = (self.inners[0].profiler if S == 1
                         else _ShardedProfiler(self))
        self.screen_cycles = 0       # cycles resolved through the screen
        self.shards_stepped = 0      # cumulative full per-shard step() calls

    # ------------------------------------------------------------------ #
    @property
    def n_regions(self) -> int:
        return len(self.inners)

    @property
    def sessions(self) -> dict[int, FleetSession]:
        """Merged live-session view (read-only by convention)."""
        if self.n_regions == 1:
            return self.inners[0].sessions
        out: dict[int, FleetSession] = {}
        for o in self.inners:
            out.update(o.sessions)
        return out

    @property
    def thresholds(self) -> Thresholds:
        return self.inners[0].thresholds

    @property
    def decisions(self) -> list[FleetDecision]:
        return (self.inners[0].decisions if self.n_regions == 1
                else self._decisions)

    @property
    def forecaster(self):
        return self.inners[0].forecaster

    @forecaster.setter
    def forecaster(self, fc) -> None:
        """One forecaster instance per region (per-region capacity history
        has region-local shapes); the assigned instance seeds region 0 and
        the rest get fresh clones of its config, on its device."""
        if self.n_regions == 1 or fc is None:
            for o in self.inners:
                o.forecaster = fc
            return
        self.inners[0].forecaster = fc
        for o in self.inners[1:]:
            o.forecaster = CapacityForecaster(fc.cfg, device=fc.device)

    @property
    def cost_model(self):
        return self.inners[0].cost_model

    @property
    def heartbeats(self):
        return self.inners[0].heartbeats

    @heartbeats.setter
    def heartbeats(self, hb) -> None:
        """A single global registry only makes sense unsharded; sharded
        storms attach per-region registries to the inners directly."""
        if self.n_regions > 1 and hb is not None:
            raise ValueError(
                "attach per-region HeartbeatRegistry instances to "
                "wrapper.inners[r].heartbeats (node ids are region-local)")
        self.inners[0].heartbeats = hb

    def locate_node(self, node: int) -> tuple[int, int]:
        """Global node id -> (region, region-local node id)."""
        return self._local_of[int(node)]

    def region_of_sid(self, sid: int) -> int:
        """The region currently hosting ``sid`` (membership IS the truth —
        no side table that could desync across cross-region migrations)."""
        for r, o in enumerate(self.inners):
            if sid in o.sessions:
                return r
        raise KeyError(sid)

    # ------------------------------------------------------------------ #
    # churn: route by ingress region
    # ------------------------------------------------------------------ #
    def admit(self, graph, workload, *, source_node: int = 0, arch: str = "",
              now: float = 0.0, qos=None, solution=None,
              prepacked=None) -> int:
        if self.n_regions == 1:
            return self.inners[0].admit(
                graph, workload, source_node=source_node, arch=arch,
                now=now, qos=qos, solution=solution, prepacked=prepacked)
        r, local = self.locate_node(source_node)
        return self.inners[r].admit(
            graph, workload, source_node=local, arch=arch, now=now,
            qos=qos, solution=solution, prepacked=prepacked)

    def depart(self, sid: int) -> FleetSession:
        if self.n_regions == 1:
            return self.inners[0].depart(sid)
        return self.inners[self.region_of_sid(sid)].depart(sid)

    # ------------------------------------------------------------------ #
    # fused per-tick pricing
    # ------------------------------------------------------------------ #
    def price_fleet(self, state: SystemState | None = None, *,
                    now: float | None = None):
        """(sids, latencies, GLOBAL node-rho) — one pricing call per shard.

        A global ``state`` is sliced per region; each region prices its own
        sessions against its own C(t) and the per-region rho vectors scatter
        back into global node coordinates.
        """
        if self.n_regions == 1:
            return self.inners[0].price_fleet(state, now=now)
        n = (state.num_nodes if state is not None
             else len(self.region_of_node))
        sids: list[int] = []
        lat_parts: list[np.ndarray] = []
        rho = np.zeros(n)
        for r, o in enumerate(self.inners):
            local = (None if state is None
                     else region_slice(state, self.node_ix[r]))
            s, lat, rho_r = o.price_fleet(local, now=now)
            sids.extend(s)
            lat_parts.append(np.asarray(lat))
            rho[self.node_ix[r]] = rho_r
        lat = (np.concatenate(lat_parts) if lat_parts else np.zeros(0))
        return sids, lat, rho

    # ------------------------------------------------------------------ #
    # screen bookkeeping
    # ------------------------------------------------------------------ #
    def _sharded(self):
        """Refresh the stacked screen state in place (the stacked row block
        is keyed on buffer stamps, so swapping the buffer objects each cycle
        is free)."""
        sh = self._shstate
        sh.shards = [o._resident() for o in self.inners]
        sh.kernels = [o.kernel for o in self.inners]
        return sh

    def _refresh_tracking(self, r: int) -> None:
        """(Re)build shard ``r``'s row-indexed EWMA/SLO/sid arrays iff the
        underlying buffer changed (admit/depart/growth); surviving rows are
        remapped BY SID from the old arrays so quiet-cycle EWMA updates are
        never lost to a rebuild."""
        o = self.inners[r]
        buf = o._buffers
        sig = (id(buf), buf.n_rows, len(buf.row_of),
               buf.stats["row_writes"])
        if self._track_sig[r] == sig:
            return
        th = o.thresholds
        B = buf.n_rows
        old_ew = {
            int(s): float(self._ewma[r][row])
            for row, s in enumerate(self._sid_at[r])
            if s >= 0 and row < len(self._ewma[r])
        }
        ew = np.full(B, np.nan)
        slo = np.full(B, th.latency_max_s)
        sid_at = np.full(B, -1, dtype=np.int64)
        for sid, row in buf.row_of.items():
            sess = o.sessions.get(sid)
            if sess is None:
                continue
            prev = old_ew.get(sid)
            if prev is None or np.isnan(prev):
                v = sess.ewma_latency.value
                prev = np.nan if v is None else float(v)
            ew[row] = prev
            if sess.qos is not None:
                slo[row] = sess.qos.latency_slo_s
            sid_at[row] = sid
        self._ewma[r], self._slo[r], self._sid_at[r] = ew, slo, sid_at
        self._track_sig[r] = sig

    def _sync_sessions_from_rows(self, r: int) -> None:
        """Push the (authoritative) wrapper EWMAs into shard ``r``'s session
        objects — required immediately before a real ``step`` so its
        trigger checks see the quiet-cycle history."""
        o = self.inners[r]
        ew = self._ewma[r]
        for sid, row in o._buffers.row_of.items():
            if row < len(ew) and np.isfinite(ew[row]):
                sess = o.sessions.get(sid)
                if sess is not None:
                    sess.ewma_latency.value = float(ew[row])

    def _sync_rows_from_sessions(self, r: int) -> None:
        """Pull post-step session EWMAs back into the wrapper arrays."""
        o = self.inners[r]
        ew = self._ewma[r]
        for sid, row in o._buffers.row_of.items():
            sess = o.sessions.get(sid)
            if sess is None or row >= len(ew):
                continue
            v = sess.ewma_latency.value
            ew[row] = np.nan if v is None else float(v)

    # ------------------------------------------------------------------ #
    # one sharded monitoring cycle
    # ------------------------------------------------------------------ #
    def step(self, now: float) -> FleetDecision:
        if self.n_regions == 1:
            return self.inners[0].step(now)
        t0 = time.perf_counter()
        inners = self.inners
        S = len(inners)
        n_sessions = sum(len(o.sessions) for o in inners)
        if n_sessions == 0 and all(
            o.heartbeats is None and o.forecaster is None for o in inners
        ):
            d = FleetDecision(t=now, per_session={}, solver_time_s=0.0,
                              n_keep=0, n_migrate=0, n_resplit=0,
                              n_cooldown=0)
            self._decisions.append(d)
            return d

        # -- 1. one vmapped screen call over all shards ------------------ #
        sh = self._sharded()
        states = [o.profiler.system_state() for o in inners]
        t_ev = time.perf_counter()
        scr = sh.screen(states, weights=inners[0].weights,
                        bw_floor=inners[0].bw_floor_frac)
        eval_time = time.perf_counter() - t_ev
        self.screen_cycles += 1
        for r in range(S):
            self._refresh_tracking(r)

        # -- 2. per-shard activation predicate (vectorized, host) -------- #
        th = self.thresholds
        a = th.ewma_alpha
        sub = []      # merged per-shard decisions
        quiet_keeps = 0
        for r, o in enumerate(inners):
            guard_q = (o.telemetry_guard is not None
                       and o.telemetry_guard.quarantined)
            must = (o.forecaster is not None or o.heartbeats is not None
                    or bool(guard_q))
            if not o.sessions:
                if must:
                    sub.append(o.step(now))
                    self.shards_stepped += 1
                continue
            # row-active mask straight from the tracking arrays (a sid is
            # tracked iff its row is allocated AND the session is live) —
            # no per-shard device fetch on the quiet path: the screen's
            # outputs came to the host in one transfer
            act = self._sid_at[r] >= 0
            lat = scr.lat[r][: len(act)]
            util = scr.max_util[r][: len(act)]
            bw = scr.min_bw[r][: len(act)]
            ew = self._ewma[r]
            # EWMA.update semantics, vectorized: first sample seeds, a
            # non-finite sample holds the last value
            cand = np.where(np.isnan(ew), lat, a * lat + (1.0 - a) * ew)
            cand = np.where(np.isfinite(lat), cand, ew)
            # NaN (not inf) marks corrupt pricing — a single-node row's
            # min_bw is legitimately +inf, and an inf latency HOLDS the EWMA
            # exactly like EWMA.update does on the monolithic path
            bad = np.isnan(lat) | np.isnan(util) | np.isnan(bw)
            with np.errstate(invalid="ignore"):
                fire = ((cand > self._slo[r]) | (util > th.util_max)
                        | (bw < th.bandwidth_min_bps) | bad)
            fire &= act
            if must or bool(fire.any()):
                # real cycle: session EWMAs must be current first, and the
                # inner step's own EWMA update supersedes the screen's
                self._sync_sessions_from_rows(r)
                sub.append(o.step(now))
                self.shards_stepped += 1
                self._refresh_tracking(r)
                self._sync_rows_from_sessions(r)
            else:
                # quiet shard: commit the screen-advanced EWMAs, KEEP all
                ew[act] = cand[act]
                quiet_keeps += len(o.sessions)

        # -- 3. cross-region migration aggregator ------------------------ #
        n_cross = self._cross_region_pass(now, scr, states)

        # -- 4. merged decision ------------------------------------------ #
        per: dict[int, Decision] = {}
        for d in sub:
            per.update(d.per_session)
        d = FleetDecision(
            t=now,
            per_session=per,
            solver_time_s=time.perf_counter() - t0,
            n_keep=sum(x.n_keep for x in sub) + quiet_keeps,
            n_migrate=sum(x.n_migrate for x in sub) + n_cross,
            n_resplit=sum(x.n_resplit for x in sub),
            n_cooldown=sum(x.n_cooldown for x in sub),
            eval_time_s=eval_time + sum(x.eval_time_s for x in sub),
            pack_time_s=sum(x.pack_time_s for x in sub),
            n_preempt=sum(x.n_preempt for x in sub),
            n_node_fail=sum(x.n_node_fail for x in sub),
            dead_nodes=tuple(sorted(self._globalize_dead(sub))),
            infeasible_sids=tuple(
                s for x in sub for s in x.infeasible_sids),
            n_conflict_keep=sum(x.n_conflict_keep for x in sub),
            n_nogain_keep=sum(x.n_nogain_keep for x in sub),
            fixed_point_sweeps=max(
                (x.fixed_point_sweeps for x in sub), default=0),
            fixed_point_aborts=sum(x.fixed_point_aborts for x in sub),
        )
        self._decisions.append(d)
        return d

    def _globalize_dead(self, sub: list[FleetDecision]) -> set[int]:
        """Stepped shards report dead nodes in local ids; map them back to
        global ids via each inner's CURRENT heartbeat registry (the inner
        decision does not carry its region, so read the live registries —
        the authoritative dead set — instead)."""
        out: set[int] = set()
        if not any(x.dead_nodes for x in sub):
            return out
        for r, o in enumerate(self.inners):
            if o.heartbeats is None:
                continue
            for local in o.heartbeats.dead():
                out.add(int(self.node_ix[r][int(local)]))
        return out

    # ------------------------------------------------------------------ #
    def _cross_region_pass(self, now: float, scr, states) -> int:
        """Top-k breach-seconds rows vs other regions' residual headroom.

        Host-side candidate nomination is O(fleet rows) numpy; only the
        nominated handful are priced, each through the TARGET region's
        existing B=1 admission-grade solve/repair path.  A move commits as
        depart(source) + admit(target, solution=...) with the sid pinned,
        so every fleet invariant (row ownership, broadcast journaling,
        weight-byte conservation) holds per region by construction.
        """
        if self.cross_top_k <= 0:
            return 0
        S = len(self.inners)
        # per-region peak rho under current load (screen totals are induced
        # node rho; add the regional background)
        rho = np.array([
            float(np.max(np.asarray(states[r].background_util)
                         + scr.tot_node[r]))
            for r in range(S)
        ])
        cands: list[tuple[float, int, int]] = []   # (breach, region, row)
        for r in range(S):
            ew = self._ewma[r]
            if not len(ew):
                continue
            ok = (self._sid_at[r] >= 0) & np.isfinite(ew)
            breach = np.where(ok, ew - self._slo[r], 0.0)
            for row in np.nonzero(breach > 0.0)[0]:
                cands.append((float(breach[row]), r, int(row)))
        if not cands:
            return 0
        cands.sort(reverse=True)
        moved = 0
        for breach, rs, row in cands[: self.cross_top_k]:
            sid = int(self._sid_at[rs][row])
            src = self.inners[rs]
            sess = src.sessions.get(sid)
            if sess is None:
                continue
            # a just-reconfigured session (including one this aggregator
            # moved) sits out its cooldown before being nominated again —
            # the same anti-thrash gate the per-region cycles apply
            if now - sess.t_last_reconfig < src.thresholds.cooldown_s:
                continue
            rt = int(np.argmin(np.where(np.arange(S) == rs, np.inf, rho)))
            if rho[rt] + self.cross_margin >= rho[rs]:
                self.cross_rejected += 1
                continue
            if self._try_cross_migrate(sess, rs, rt, states[rt], now):
                moved += 1
                # keep later candidates honest about the load just moved
                lam_rho = float(np.max(scr.tot_node[rs]) /
                                max(1, len(src.sessions) + 1))
                rho[rt] += lam_rho
            else:
                self.cross_rejected += 1
        return moved

    def _try_cross_migrate(self, sess: FleetSession, rs: int, rt: int,
                           state_t: SystemState, now: float) -> bool:
        """Price ``sess`` into region ``rt``; commit only on a QoS win."""
        tgt = self.inners[rt]
        src = self.inners[rs]
        slo = (sess.qos.latency_slo_s if sess.qos is not None
               else tgt.thresholds.latency_max_s)
        cur = self._ewma[rs][src._buffers.row_of[sess.sid]]
        # mirror ingress: regions are homogeneous cluster replicas, so the
        # session's region-local source index carries over (clamped)
        local_src = min(int(sess.source_node), state_t.num_nodes - 1)
        eff = tgt.effective_state(
            state_t, _table=tgt.resident_table(state_t))
        try:
            [sol] = tgt.splitter.solve_batch(
                [SessionProblem(
                    sess.graph, sess.workload, source_node=local_src,
                    input_bytes_per_token=sess.input_bytes_per_token,
                    prepacked=sess.prepacked)],
                eff, max_units=tgt.max_units,
            )
        except Exception:
            return False
        sol = coalesce_same_node(sol)
        sol = tgt.repair_solution(
            sess.graph, sol, eff, sess.workload, source_node=local_src,
            input_bytes_per_token=sess.input_bytes_per_token)
        if memory_violations(
            sess.graph, sol.boundaries, sol.assignment, eff
        ).any():
            return False
        lat_new = tgt.cost_model.chain_latency(
            sess.graph, sol.boundaries, sol.assignment, eff, sess.workload)
        gain_ok = (lat_new <= slo or
                   (np.isfinite(cur) and
                    lat_new < cur * (1.0 - src.min_improvement_frac)))
        if not gain_ok:
            return False
        # commit: depart source, admit target with the sid pinned
        sess = src.depart(sess.sid)
        saved = tgt._next_sid
        tgt._next_sid = sess.sid
        try:
            tgt.admit(
                sess.graph, sess.workload, source_node=local_src,
                arch=sess.arch, now=now, qos=sess.qos, solution=sol,
                prepacked=sess.prepacked,
            )
        except AdmissionRolloutError:
            # rollout aborted: the session never left — restore it in the
            # source region exactly as it was
            src.sessions[sess.sid] = sess
            src._upsert_row(sess)
            return False
        finally:
            tgt._next_sid = max(saved, tgt._next_sid)
        new = tgt.sessions[sess.sid]
        new.ewma_latency = sess.ewma_latency
        new.t_admitted = sess.t_admitted
        new.input_bytes_per_token = sess.input_bytes_per_token
        self.cross_migrations += 1
        return True
