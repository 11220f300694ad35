"""Control-plane chaos campaigns + the cycle invariant checker.

:class:`~repro_torch.edgesim.failures.FailureInjector` attacks the *data
plane* — nodes die, links flap.  This module attacks the *control plane*:
the orchestrator process crashes and restarts, its reconfiguration RPCs
drop/delay/duplicate, and the telemetry it reads arrives corrupt.  Same
purity contract as the failure injector: the whole campaign (crash
instants, RPC-fault windows, corruption events) is pre-drawn at
construction from ``spec.seed``, and every query is a pure read — so a
seed-paired A/B (handling off vs on) sees the *identical* fault timeline
and differs only in how the controller copes.

:class:`InvariantChecker` is the other half of the harness: after every
monitoring cycle it asserts the properties a resilient control plane must
never violate, whatever the campaign did — config coherence across agents,
monotone committed versions, conservation between host configs and the
device-resident rows, a bounded defer queue, and zero tier-0 preemptions.
Violations are *recorded*, not raised: the benchmark counts them per arm
(the handling-ON acceptance gate is exactly zero), tests assert the list is
empty.  The resident rows live on the orchestrator's device; a check copies
the two tables it reads to the host in one transfer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.cost_model import SystemState
from ..core.fleet_eval import to_host
from .failures import _down_intervals

__all__ = ["ChaosSpec", "ChaosInjector", "InvariantChecker"]


@dataclass(frozen=True)
class ChaosSpec:
    """One pre-drawable control-plane fault campaign.

    All rates are Poisson arrivals over the sim horizon; explicit
    ``crash_times`` are merged with the drawn ones.  RPC fault windows arm
    the :class:`~repro_torch.core.broadcast.FlakyAgent` wrappers with the given
    drop/duplicate/delay probabilities; telemetry events write NaN into one
    node's background-utilization (and its link row) for the window — the
    classic scrape-races-a-counter-reset corruption.
    """

    seed: int = 0
    # controller crash/restart
    crash_rate_per_s: float = 0.0
    crash_times: tuple[float, ...] = ()
    min_crash_spacing_s: float = 10.0
    zombie_after_crash: bool = True      # pre-crash controller fires one
    # RPC transport faults (prepare/commit)
    rpc_fault_rate_per_s: float = 0.0    # window arrivals
    rpc_fault_duration_s: float = 5.0
    rpc_drop_p: float = 0.2
    rpc_dup_p: float = 0.15
    rpc_delay_p: float = 0.1
    # telemetry corruption
    telemetry_rate_per_s: float = 0.0    # event arrivals
    telemetry_duration_s: float = 3.0
    telemetry_nodes: tuple[int, ...] = ()  # empty → every node eligible


class ChaosInjector:
    """Pre-drawn realization of a :class:`ChaosSpec` over one sim horizon.

    Construction draws the full campaign; every method after that is a pure
    read of ``(t)`` — the injector carries no mutable state, mirroring
    :class:`~repro_torch.edgesim.failures.FailureInjector`.
    """

    def __init__(self, spec: ChaosSpec, *, num_nodes: int,
                 horizon_s: float) -> None:
        self.spec = spec
        self.num_nodes = num_nodes
        self.horizon_s = horizon_s
        rng = np.random.default_rng(spec.seed)

        crashes: list[float] = []
        if spec.crash_rate_per_s > 0:
            t = float(rng.exponential(1.0 / spec.crash_rate_per_s))
            while t < horizon_s:
                crashes.append(t)
                t += max(spec.min_crash_spacing_s,
                         float(rng.exponential(1.0 / spec.crash_rate_per_s)))
        crashes.extend(float(c) for c in spec.crash_times if c < horizon_s)
        last = float("-inf")
        kept = []
        for c in sorted(crashes):
            if c - last >= spec.min_crash_spacing_s:
                kept.append(c)
                last = c
        self.crash_times: tuple[float, ...] = tuple(kept)

        self.rpc_windows: tuple[tuple[float, float], ...] = tuple(
            () if spec.rpc_fault_rate_per_s <= 0 else _down_intervals(
                rng, 1.0 / spec.rpc_fault_rate_per_s,
                spec.rpc_fault_duration_s, horizon_s)
        )

        events: list[tuple[float, float, int]] = []
        if spec.telemetry_rate_per_s > 0:
            eligible = (tuple(spec.telemetry_nodes) or
                        tuple(range(num_nodes)))
            for t0, t1 in _down_intervals(
                    rng, 1.0 / spec.telemetry_rate_per_s,
                    spec.telemetry_duration_s, horizon_s):
                events.append((t0, t1, int(rng.choice(eligible))))
        self.telemetry_events: tuple[tuple[float, float, int], ...] = (
            tuple(events))

    # -- pure reads ----------------------------------------------------- #
    def rpc_fault_active(self, t: float) -> bool:
        return any(t0 <= t < t1 for t0, t1 in self.rpc_windows)

    def corrupted_nodes(self, t: float) -> tuple[int, ...]:
        return tuple(sorted({n for t0, t1, n in self.telemetry_events
                             if t0 <= t < t1}))

    def corrupt(self, state: SystemState, t: float) -> SystemState:
        """Overlay telemetry corruption: NaN utilization + NaN link row for
        every node with an active corruption event.  Returns ``state``
        itself when nothing is active (seed-paired fast path)."""
        nodes = self.corrupted_nodes(t)
        if not nodes:
            return state
        st = state.copy()
        for n in nodes:
            st.background_util[n] = np.nan
            st.link_bw[n, :] = np.nan
            st.link_bw[n, n] = np.inf
        return st


@dataclass
class InvariantChecker:
    """Post-cycle assertions over orchestrator + data plane + admission.

    ``check`` returns (and records) violation strings; an empty return means
    the cycle upheld every invariant.  The recorded list is bounded so a
    persistently broken arm (the point of the handling-OFF baseline) cannot
    grow without limit.
    """

    queue_cap: int | None = None
    max_recorded: int = 10_000
    violations: list[tuple[float, str]] = field(default_factory=list)

    def check(self, *, t: float, orch, agents, admission=None) -> list[str]:
        errs: list[str] = []
        inner = [a.inner if hasattr(a, "inner") else a for a in agents]

        # 1. config coherence: every agent holding an active config for a
        #    live session agrees on ONE version — and it is the version the
        #    controller believes is active (a zombie overwrite breaks this)
        for sid, sess in orch.sessions.items():
            held = {a.node_id: a.active_by[sid].version
                    for a in inner if sid in a.active_by}
            versions = set(held.values())
            if len(versions) > 1:
                errs.append(
                    f"session {sid}: agents disagree on active config "
                    f"({held})")
            if sess.config is not None and versions - {sess.config.version}:
                errs.append(
                    f"session {sid}: agent active version(s) "
                    f"{sorted(versions)} != controller's "
                    f"{sess.config.version}")

        # 2. monotone broadcast versions: each agent's commit history must
        #    be strictly increasing (a version-counter restart re-issues
        #    old numbers; idempotent dedup makes the *replay* a no-op, so
        #    any non-monotone append is a real protocol violation)
        for a in inner:
            h = a.history
            bad = [i for i in range(1, len(h)) if h[i] <= h[i - 1]]
            if bad:
                errs.append(
                    f"agent {a.node_id}: non-monotone commit history at "
                    f"{[(h[i - 1], h[i]) for i in bad[:3]]}")

        # 3. capacity conservation: the device-resident rows must mirror
        #    the host-side session set exactly — same sids, and each row's
        #    total weight bytes equal to its graph's (nothing lost or
        #    double-counted between host configs and device accounting)
        buf = orch._buffers
        if buf is not None:
            missing = set(orch.sessions) - set(buf.row_of)
            extra = set(buf.row_of) - set(orch.sessions)
            if missing or extra:
                errs.append(
                    f"resident rows out of sync: missing={sorted(missing)} "
                    f"extra={sorted(extra)}")
            else:
                # one device→host copy of both tables, not one per session
                segw, valid = to_host(buf.seg_wbytes, buf.valid)
                for sid, sess in orch.sessions.items():
                    row = buf.row_of[sid]
                    got = float(segw[row][valid[row]].sum())
                    want = float(np.asarray(sess.graph.weight_bytes).sum())
                    if not np.isclose(got, want, rtol=1e-9, atol=1.0):
                        errs.append(
                            f"session {sid}: resident row weight "
                            f"{got:.3e} != graph total {want:.3e}")

        # 4. bounded defer queue
        if admission is not None:
            cap = (self.queue_cap if self.queue_cap is not None
                   else admission.queue_cap)
            if admission.queued > cap:
                errs.append(
                    f"defer queue over cap: {admission.queued} > {cap}")
            # 5. zero tier-0 preemptions: interactive sessions are never
            #    revoked, whatever the campaign does
            n0 = admission.preempted_by_class.get("interactive", 0)
            if n0:
                errs.append(f"tier-0 (interactive) preemptions: {n0}")

        room = self.max_recorded - len(self.violations)
        if room > 0:
            self.violations.extend((t, e) for e in errs[:room])
        return errs
