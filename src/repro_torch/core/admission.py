"""Latency-priced admission control for the edge fleet (control-plane stage).

An arriving session is priced against the fleet's *residual* capacity before
it is placed:

1. The session is solved with the fleet's
   :class:`~repro_torch.core.splitter.BatchedJointSplitter` against the
   shared capacity with every live session's induced node load, link
   traffic and resident weights folded into C(t)
   (:meth:`~repro_torch.core.fleet.FleetOrchestrator.effective_state`), the
   fleet totals coming from the orchestrator's device-resident tables.
2. The best feasible split's end-to-end latency is compared with the
   session's :class:`~repro_torch.core.triggers.QoSClass` SLO, and the
   placement's projected node load with ``rho_ceiling`` (ρ > 1 anywhere
   means the fleet cannot sustain the arrival rate at all).
3. ACCEPT deploys the already-solved split through
   :meth:`~repro_torch.core.fleet.FleetOrchestrator.admit` (no re-solve);
   DEFER parks the request in a bounded FIFO retried on :meth:`poll` until
   the QoS class's patience runs out; REJECT is final.

The controller owns no tensors: it packs on ``orchestrator.splitter`` and
prices on the orchestrator, so every verdict runs on the orchestrator's
device.  KPIs (accept/reject/defer/expire/preempt counts) are surfaced
through :attr:`FleetAdmissionController.counters` and :meth:`kpis`.
:class:`ShardedFleetAdmissionController` routes each request by its global
ingress node to one such controller per MEC region of a
:class:`~repro_torch.core.fleet.ShardedFleetOrchestrator`.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field, replace as _dc_replace

import numpy as np

from .cost_model import (CostModel, Workload, memory_violations, node_loads,
                         region_slice)
from .fleet import (
    AdmissionRolloutError,
    FleetOrchestrator,
    FleetSession,
    _graph_from_dict,
    _graph_to_dict,
    _qos_from_dict,
    _qos_to_dict,
    _workload_to_dict,
    session_induced_loads,
)
from .graph import ModelGraph
from .placement import Solution
from .splitter import PackedProblem, SessionProblem, coalesce_same_node
from .triggers import QOS_STANDARD, QoSClass

__all__ = [
    "AdmissionKind",
    "AdmissionRequest",
    "AdmissionVerdict",
    "FleetAdmissionController",
    "ShardedFleetAdmissionController",
]


class AdmissionKind(enum.Enum):
    ACCEPT = "accept"
    DEFER = "defer"
    REJECT = "reject"


@dataclass(frozen=True)
class AdmissionRequest:
    """One session asking to join the fleet."""

    graph: ModelGraph
    workload: Workload
    source_node: int = 0
    arch: str = ""
    qos: QoSClass = QOS_STANDARD
    input_bytes_per_token: float = 4.0
    t_submit: float = 0.0
    # True when this request is a live session revoked by preempt_overload
    # re-entering through the defer queue: a later ACCEPT counts as a
    # RECOVERY, not a fresh admission
    preempted: bool = False


@dataclass(frozen=True)
class AdmissionVerdict:
    kind: AdmissionKind
    sid: int | None = None              # set on ACCEPT
    predicted_latency_s: float = float("inf")
    reason: str = ""
    solution: Solution | None = None    # the priced split (ACCEPT only)


@dataclass
class FleetAdmissionController:
    """Prices arriving sessions against residual capacity; queues the rest.

    ``rho_ceiling`` bounds the projected post-admission node utilization
    (background + every live session + the candidate's own raw λ·service):
    admitting past ρ = 1 puts the fleet into an unsustainable steady state
    no later migration can fix.  ``max_sessions`` is a hard cap above the
    priced checks (bounding orchestrator state, not capacity).
    """

    orchestrator: FleetOrchestrator
    max_sessions: int = 64
    rho_ceiling: float = 1.0
    queue_cap: int = 16
    # pricing provider: defaults to the orchestrator's, so admission verdicts
    # and fleet pricing always agree on calibrated-vs-analytic coefficients
    cost_model: CostModel | None = None
    # forecast-aware pricing: when the orchestrator carries a ready
    # CapacityForecaster, the arrival is solved and priced against the WORST
    # capacity within the horizon (max background util, min link bandwidth)
    # instead of the instantaneous snapshot, so a trough-time admit that
    # would violate at the next spike DEFERs now and re-prices on poll
    use_forecast: bool = True
    # how long a preempted session waits in the defer queue for capacity to
    # return before it is finally dropped; None → the session's own QoS
    # defer patience (tuned for admission latency, usually far shorter than
    # a node's repair time)
    preempt_patience_s: float | None = None
    counters: dict[str, int] = field(default_factory=lambda: {
        "requests": 0, "accepted": 0, "accepted_from_queue": 0,
        "rejected": 0, "deferred": 0, "expired": 0,
        "preempted": 0, "recovered": 0,
    })
    # preemption counts by QoS-class name: under storm overload, "batch"
    # should absorb the evictions
    preempted_by_class: dict[str, int] = field(default_factory=dict)
    # (deadline, AdmissionRequest, PackedProblem | None): a deferred request
    # keeps its packed problem tensors (on the orchestrator's device), so a
    # retry re-prices against the current residual capacity without
    # re-coarsening the graph
    _queue: deque = field(default_factory=deque)
    # fleet load-table memo: a burst of arrivals (plus the defer-queue poll)
    # prices against the SAME C(t), and the device totals only change when
    # the session set or a rollout does — one resident_table price (one
    # host copy) per (now, live sids, broadcast version)
    _table_key: tuple = ()
    _table_cache: tuple | None = None

    def __post_init__(self) -> None:
        if self.cost_model is None:
            self.cost_model = self.orchestrator.cost_model

    # ------------------------------------------------------------------ #
    @property
    def queued(self) -> int:
        return len(self._queue)

    def _prepack(
        self, req: AdmissionRequest, pp: PackedProblem | None
    ) -> PackedProblem | None:
        """The request's state-independent problem tensors (packed ONCE).

        Skipped while the fleet sits at the session cap: ``_price_and_admit``
        rejects those before solving.  A request deferred at the cap (or
        restored from a journal, which keeps no packs) picks its pack up on
        the first below-cap poll, on the orchestrator's device.
        """
        if pp is None and len(self.orchestrator.sessions) < self.max_sessions:
            orch = self.orchestrator
            pp = orch.splitter.pack_problem(
                req.graph, max_units=orch.max_units,
                input_bytes_per_token=req.input_bytes_per_token,
            )
        return pp

    def request(self, req: AdmissionRequest, *, now: float = 0.0) -> AdmissionVerdict:
        """Admission decision for a fresh arrival (may enqueue a deferral)."""
        self.counters["requests"] += 1
        pp = self._prepack(req, None)
        v = self._price_and_admit(req, now, pp)
        if v.kind is AdmissionKind.ACCEPT:
            self.counters["accepted"] += 1
            return v
        if req.qos.defer_timeout_s > 0 and len(self._queue) < self.queue_cap:
            self._queue.append((now + req.qos.defer_timeout_s, req, pp))
            self.counters["deferred"] += 1
            return AdmissionVerdict(
                AdmissionKind.DEFER, None, v.predicted_latency_s, v.reason
            )
        self.counters["rejected"] += 1
        return AdmissionVerdict(
            AdmissionKind.REJECT, None, v.predicted_latency_s, v.reason
        )

    def poll(self, now: float) -> list[tuple[AdmissionRequest, AdmissionVerdict]]:
        """Retry the defer queue; expired requests become final REJECTs.

        Returns the requests that left the queue this poll, with their
        verdicts (ACCEPT or REJECT-by-timeout), in queue order.  Each retry
        re-solves against the CURRENT residual capacity but reuses the
        request's packed tensors.
        """
        out: list[tuple[AdmissionRequest, AdmissionVerdict]] = []
        still: deque = deque()
        while self._queue:
            deadline, req, pp = self._queue.popleft()
            if now > deadline:
                self.counters["expired"] += 1
                out.append((req, AdmissionVerdict(
                    AdmissionKind.REJECT,
                    reason=f"defer timeout ({req.qos.name})",
                )))
                continue
            pp = self._prepack(req, pp)   # no-op unless submitted at-cap
            v = self._price_and_admit(req, now, pp)
            if v.kind is AdmissionKind.ACCEPT:
                self.counters["accepted"] += 1
                self.counters["accepted_from_queue"] += 1
                if req.preempted:
                    self.counters["recovered"] += 1
                out.append((req, v))
            else:
                still.append((deadline, req, pp))
        self._queue = still
        return out

    # ------------------------------------------------------------------ #
    def _fleet_table(self, state, now: float):
        orch = self.orchestrator
        # broadcast version folds monitoring-cycle commits (same session
        # set, new placements) into the key
        key = (now, tuple(orch.sessions), orch.broadcast.active_version)
        if key != self._table_key:
            self._table_key = key
            self._table_cache = orch.resident_table(state)
        return self._table_cache

    def _price_and_admit(
        self,
        req: AdmissionRequest,
        now: float,
        prepacked: PackedProblem | None = None,
    ) -> AdmissionVerdict:
        """Solve the joint split on residual capacity; admit iff inside QoS."""
        orch = self.orchestrator
        if len(orch.sessions) >= self.max_sessions:
            return AdmissionVerdict(
                AdmissionKind.REJECT,
                reason=f"session cap {self.max_sessions} reached",
            )
        state = orch.observed_state(now=now)
        table = self._fleet_table(state, now)
        # the capacity the fleet load is folded into: worst case within the
        # forecast horizon when available, the instantaneous C(t) otherwise
        base = orch.forecast_base(state) if self.use_forecast else state
        eff = orch.effective_state(state, _table=table, base=base)

        # price on the provider's calibrated view (identity when analytic)
        graph = self.cost_model.calibrated(req.graph)
        [sol] = orch.splitter.solve_batch(
            [SessionProblem(graph, req.workload,
                            source_node=req.source_node,
                            input_bytes_per_token=req.input_bytes_per_token,
                            prepacked=prepacked)],
            eff, max_units=orch.max_units,
        )
        sol = coalesce_same_node(sol)
        if memory_violations(
            graph, sol.boundaries, sol.assignment, eff
        ).any():
            # Eq. 4 repair through the fleet's batched device pass
            sol = orch.repair_solution(
                graph, sol, eff, req.workload,
                source_node=req.source_node,
                input_bytes_per_token=req.input_bytes_per_token,
            )
            if memory_violations(
                graph, sol.boundaries, sol.assignment, eff
            ).any():
                return AdmissionVerdict(
                    AdmissionKind.REJECT,
                    reason="insufficient residual memory for model weights",
                )

        lat = self.cost_model.chain_latency(
            graph, sol.boundaries, sol.assignment, eff, req.workload
        )
        fc = " within forecast horizon" if base is not state else ""
        if lat > req.qos.latency_slo_s:
            return AdmissionVerdict(
                AdmissionKind.REJECT, None, lat,
                reason=(f"best feasible latency {lat*1e3:.0f}ms exceeds "
                        f"{req.qos.name} SLO "
                        f"{req.qos.latency_slo_s*1e3:.0f}ms{fc}"),
            )

        # projected fleet utilization with the candidate placed: worst-case
        # background within the horizon (= current background when
        # reactive) + every live session's induced load + the candidate's
        # own raw λ·service; summed in this order on the host
        own_rho = node_loads(
            graph, sol.boundaries, sol.assignment, state, req.workload
        ) - state.background_util
        proj = base.background_util + table[1] + own_rho
        if float(proj.max()) > self.rho_ceiling:
            return AdmissionVerdict(
                AdmissionKind.REJECT, None, lat,
                reason=(f"projected node rho {proj.max():.2f} exceeds "
                        f"ceiling {self.rho_ceiling:.2f}{fc}"),
            )

        # incumbent guard (forecast mode only): an arrival that fits its own
        # SLO may still bury a long-lived tenant under the added contention —
        # re-price every live session with the candidate folded in (against
        # the worst-case horizon capacity) and refuse to CAUSE a breach
        if base is not state and orch.sessions:
            isids, lat0, lat1 = orch.price_incumbents_with_candidate(
                graph, sol, req.workload,
                source_node=req.source_node,
                input_bytes_per_token=req.input_bytes_per_token,
                state=state, base=base,
            )
            slo = np.array([
                orch.sessions[s].qos.latency_slo_s
                if orch.sessions[s].qos is not None
                else orch.thresholds.latency_max_s
                for s in isids
            ])
            caused = (lat1 > slo) & (lat0 <= slo)
            if caused.any():
                i = int(np.argmax(caused))
                return AdmissionVerdict(
                    AdmissionKind.REJECT, None, lat,
                    reason=(f"would push session {isids[i]} "
                            f"({lat1[i]*1e3:.0f}ms > "
                            f"{slo[i]*1e3:.0f}ms SLO){fc}"),
                )

        try:
            sid = orch.admit(
                graph, req.workload, source_node=req.source_node,
                arch=req.arch, now=now, qos=req.qos, solution=sol,
                prepacked=prepacked,
            )
        except AdmissionRolloutError as e:
            # deploy broadcast aborted (transport faults, fenced epoch) —
            # capacity was fine, so DEFER and retry when the path heals
            return AdmissionVerdict(AdmissionKind.DEFER, None, lat,
                                    reason=str(e))
        return AdmissionVerdict(AdmissionKind.ACCEPT, sid, lat,
                                reason="within SLO and rho ceiling",
                                solution=sol)

    # ------------------------------------------------------------------ #
    # revocation / preemption with graceful degradation
    # ------------------------------------------------------------------ #
    @staticmethod
    def _expendability(sess: FleetSession) -> tuple[float, float]:
        """Sort key: most expendable FIRST (loosest SLO, then newest).

        Interactive tenants (tight SLO) are preempted last; among equals,
        the longest-lived session keeps its seat.
        """
        slo = (sess.qos.latency_slo_s if sess.qos is not None
               else QOS_STANDARD.latency_slo_s)
        return (-slo, -sess.t_admitted)

    def preempt_overload(
        self, now: float, *, state=None
    ) -> list[tuple[FleetSession, AdmissionRequest | None]]:
        """Revoke sessions until resident weights fit the surviving memory.

        The orchestrator's commit gate can only KEEP an infeasible incumbent
        when the surviving fleet has no room — someone has to go, and WHICH
        one is an admission-policy question: evict the most expendable
        session touching an over-committed node, requeue it into the defer
        queue with ``preempt_patience_s``, and repeat until Eq. 4 holds
        fleet-wide.  If the fleet-wide most expendable session outranks
        every on-node one, it is evicted instead (freeing survivor capacity
        for next cycle's forced migration) and the pass stops.  Event-driven
        host work, O(B²) in the session count; never per cycle.

        Returns the evicted ``(session, requeued request | None)`` pairs
        (request is None when the defer queue was full — a hard drop).
        """
        orch = self.orchestrator
        if state is None:
            state = orch.observed_state(now=now)
        out: list[tuple[FleetSession, AdmissionRequest | None]] = []
        while orch.sessions:
            wb = {
                sid: session_induced_loads(s, state)[2]
                for sid, s in orch.sessions.items()
            }
            used = np.sum(list(wb.values()), axis=0)
            over = used - np.asarray(state.mem_bytes, dtype=float)
            overfull = over > 1.0  # bytes; exact fit is feasible
            if not overfull.any():
                break
            on_over = [
                sid for sid in orch.sessions if wb[sid][overfull].any()
            ]
            if not on_over:
                break
            key = lambda sid: self._expendability(orch.sessions[sid])  # noqa: E731
            victim = min(on_over, key=key)
            fleet_wide = min(orch.sessions, key=key)
            if key(fleet_wide) < key(victim):
                out.append(self._evict(fleet_wide, now))
                break
            out.append(self._evict(victim, now))
        return out

    def _evict(
        self, sid: int, now: float
    ) -> tuple[FleetSession, AdmissionRequest | None]:
        """Depart ``sid`` and requeue it as a preempted admission request
        (its device pack rides along)."""
        orch = self.orchestrator
        sess = orch.depart(sid)
        self.counters["preempted"] += 1
        qname = sess.qos.name if sess.qos is not None else "default"
        self.preempted_by_class[qname] = (
            self.preempted_by_class.get(qname, 0) + 1
        )
        req = AdmissionRequest(
            graph=sess.graph, workload=sess.workload,
            source_node=sess.source_node, arch=sess.arch,
            qos=sess.qos if sess.qos is not None else QOS_STANDARD,
            input_bytes_per_token=sess.input_bytes_per_token,
            t_submit=now, preempted=True,
        )
        patience = (self.preempt_patience_s
                    if self.preempt_patience_s is not None
                    else req.qos.defer_timeout_s)
        if len(self._queue) < self.queue_cap:
            self._queue.append((now + patience, req, sess.prepacked))
            return sess, req
        self.counters["rejected"] += 1
        return sess, None

    # ------------------------------------------------------------------ #
    def kpis(self) -> dict[str, float]:
        c = dict(self.counters)
        denom = max(1, c["requests"])
        return {
            **{k: float(v) for k, v in c.items()},
            "accept_frac": c["accepted"] / denom,
            "reject_frac": (c["rejected"] + c["expired"]) / denom,
            "queued_now": float(len(self._queue)),
            **{f"preempted_{name}": float(v)
               for name, v in sorted(self.preempted_by_class.items())},
        }

    # ------------------------------------------------------------------ #
    # crash-recoverable state: the defer queue and counters fold into the
    # orchestrator journal (FleetOrchestrator.state_dict(admission=...));
    # the queue is the one place a not-yet-admitted tenant's state lives
    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        return {
            "counters": dict(self.counters),
            "preempted_by_class": dict(self.preempted_by_class),
            "queue": [
                {
                    "deadline": float(deadline),
                    "request": {
                        "graph": _graph_to_dict(req.graph),
                        "workload": _workload_to_dict(req.workload),
                        "source_node": req.source_node,
                        "arch": req.arch,
                        "qos": _qos_to_dict(req.qos),
                        "input_bytes_per_token": req.input_bytes_per_token,
                        "t_submit": req.t_submit,
                        "preempted": req.preempted,
                    },
                }
                # the packed-problem tensors are device state, rebuilt
                # lazily by _prepack on the first post-restore poll
                for deadline, req, _pp in self._queue
            ],
        }

    def load_state_dict(self, d: dict) -> None:
        self.counters.update({k: int(v) for k, v in d["counters"].items()})
        self.preempted_by_class = {
            k: int(v) for k, v in d["preempted_by_class"].items()
        }
        self._queue = deque(
            (
                float(e["deadline"]),
                AdmissionRequest(
                    graph=_graph_from_dict(r["graph"]),
                    workload=Workload(**r["workload"]),
                    source_node=int(r["source_node"]),
                    arch=r["arch"],
                    qos=_qos_from_dict(r["qos"]),
                    input_bytes_per_token=float(r["input_bytes_per_token"]),
                    t_submit=float(r["t_submit"]),
                    preempted=bool(r["preempted"]),
                ),
                None,
            )
            for e in d["queue"]
            for r in [e["request"]]
        )
        self._table_key, self._table_cache = (), None


class ShardedFleetAdmissionController:
    """Region-routed admission over a :class:`ShardedFleetOrchestrator`.

    One :class:`FleetAdmissionController` per region, each pricing arrivals
    against ITS region's residual capacity only (exact under the
    block-diagonal sharding — a session never consumes another region's
    nodes).  A request's GLOBAL ingress node picks the region; the request
    is re-addressed into region-local coordinates before pricing, so the
    per-region controllers are completely unaware they are shards.  The
    defer queues stay per-region (a deferred tenant retries where it
    arrived — MEC ingress is geographic, not fungible), and the KPI surface
    aggregates across regions.
    """

    def __init__(self, orchestrator, *, max_sessions: int = 64,
                 rho_ceiling: float = 1.0, queue_cap: int = 16,
                 cost_model: CostModel | None = None,
                 use_forecast: bool = True,
                 preempt_patience_s: float | None = None) -> None:
        self.orchestrator = orchestrator
        S = orchestrator.n_regions
        per_cap = max(1, max_sessions // S)
        per_queue = max(1, queue_cap // S) if S > 1 else queue_cap
        self.max_sessions = max_sessions
        self.queue_cap = queue_cap
        self.regional = [
            FleetAdmissionController(
                inner, max_sessions=per_cap if S > 1 else max_sessions,
                rho_ceiling=rho_ceiling, queue_cap=per_queue,
                cost_model=cost_model, use_forecast=use_forecast,
                preempt_patience_s=preempt_patience_s,
            )
            for inner in orchestrator.inners
        ]

    # -- routing ------------------------------------------------------- #
    def _route(self, req: AdmissionRequest) -> tuple[int, AdmissionRequest]:
        if self.orchestrator.n_regions == 1:
            return 0, req
        r, local = self.orchestrator.locate_node(req.source_node)
        return r, _dc_replace(req, source_node=local)

    def request(self, req: AdmissionRequest, *,
                now: float = 0.0) -> AdmissionVerdict:
        r, req = self._route(req)
        return self.regional[r].request(req, now=now)

    def poll(self, now: float):
        out = []
        for c in self.regional:
            out.extend(c.poll(now))
        return out

    def preempt_overload(self, now: float, *, state=None):
        """Per-region revocation; a supplied global state is sliced."""
        out = []
        for r, c in enumerate(self.regional):
            local = None
            if state is not None and self.orchestrator.n_regions > 1:
                local = region_slice(state, self.orchestrator.node_ix[r])
            elif state is not None:
                local = state
            out.extend(c.preempt_overload(now, state=local))
        return out

    # -- aggregated KPI surface ---------------------------------------- #
    @property
    def preempt_patience_s(self):
        return self.regional[0].preempt_patience_s

    @preempt_patience_s.setter
    def preempt_patience_s(self, v) -> None:
        for c in self.regional:
            c.preempt_patience_s = v

    @property
    def queued(self) -> int:
        return sum(c.queued for c in self.regional)

    @property
    def counters(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for c in self.regional:
            for k, v in c.counters.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def preempted_by_class(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for c in self.regional:
            for k, v in c.preempted_by_class.items():
                out[k] = out.get(k, 0) + v
        return out

    def kpis(self) -> dict[str, float]:
        c = self.counters
        denom = max(1, c["requests"])
        return {
            **{k: float(v) for k, v in c.items()},
            "accept_frac": c["accepted"] / denom,
            "reject_frac": (c["rejected"] + c["expired"]) / denom,
            "queued_now": float(self.queued),
            **{f"preempted_{name}": float(v)
               for name, v in sorted(self.preempted_by_class.items())},
        }
