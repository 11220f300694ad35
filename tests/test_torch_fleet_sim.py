"""The port's ``FleetSimulator`` against the reference program, on the CPU.

Seed-paired runs at the sizes of the reference's own tests go through both
packages (the port with ``device="cpu"``): tests/test_fleet.py's 12 s churn,
tests/test_fault_tolerance.py's empty ``FailureSpec`` (bit-identical to no
injector) and its 30 s cap-8 storm, tests/test_chaos.py's 20 s mini A/B
(both arms, with its invariant assertions), and a 3-region run through the
sharded control plane.  Session logs, per-tick counts and ``chaos_stats``
(the restore's wall clock aside) are identical; latencies and node ρ agree
to 1e-12 relative, NaN where the reference has NaN.  The
``InvariantChecker`` flags the tampered states of
tests/test_chaos.py::test_invariant_checker_clean_and_tampered.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

import repro.core as R
import repro.edgesim as RE
import repro_torch.core as T
import repro_torch.edgesim as TE

RTOL = 1e-12


@pytest.fixture(autouse=True)
def x64_shim():
    """The reference spells ``jax.experimental.enable_x64``, which newer JAX
    releases dropped; alias it to ``jax.enable_x64`` for this test only."""
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = jax.enable_x64
    yield
    if added:
        del jax.experimental.enable_x64


def _sim(mod, sim_kw, journal=None, **kw):
    if journal is not None:
        sim_kw = dict(sim_kw, journal_path=str(journal))
    p = mod.FleetScenarioParams(sim=mod.FleetSimConfig(**sim_kw))
    extra = {"device": "cpu"} if mod is TE else {}
    return mod.build_fleet_scenario(p, **extra, **kw)


_COUNTS = ("t", "n_sessions", "admitted", "departed", "rejected", "deferred",
           "n_migrate", "n_resplit", "n_preempt", "n_dead_nodes", "preempted",
           "recovered", "n_conflict_keep", "fp_sweeps", "qos_violation_frac",
           "mem_violation_bytes", "solver_time_s")


def _close(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    m = ~np.isnan(a)
    return bool(np.all(np.abs(a[m] - b[m])
                       <= RTOL * np.maximum(np.abs(a[m]), np.abs(b[m]))))


def _kpis(res, t0, t1):
    """``kpis()`` without its one wall-clock entry."""
    return {k: v for k, v in res.kpis(t0, t1).items() if k != "mean_solver_ms"}


def _assert_same_run(mine, ref, sim_m=None, sim_r=None):
    assert mine.session_log == ref.session_log
    assert len(mine.ticks) == len(ref.ticks)
    for a, b in zip(mine.ticks, ref.ticks):
        ca = [getattr(a, f) for f in _COUNTS if f != "solver_time_s"]
        cb = [getattr(b, f) for f in _COUNTS if f != "solver_time_s"]
        assert ca == cb, (a.t, ca, cb)
        # a monitoring cycle ran in one package iff it ran in the other
        assert (a.solver_time_s > 0) == (b.solver_time_s > 0), a.t
        assert _close(a.latencies, b.latencies), a.t
        assert _close(a.node_rho, b.node_rho), a.t
    if sim_m is not None:
        drop = "max_restore_wall_s"
        assert {k: v for k, v in sim_m.chaos_stats.items() if k != drop} == \
            {k: v for k, v in sim_r.chaos_stats.items() if k != drop}


_CHURN = dict(duration_s=12.0, max_sessions=6, initial_sessions=2,
              session_arrival_per_s=0.5, mean_lifetime_s=8.0, seed=11)


def test_churn_matches_reference():
    """tests/test_fleet.py's 12 s churn: churn happens, metrics sane."""
    mine = _sim(TE, _CHURN).run()
    ref = _sim(RE, _CHURN).run()
    _assert_same_run(mine, ref)
    assert sum(e[1] == "admit" for e in mine.session_log) >= 3
    assert sum(e[1] == "depart" for e in mine.session_log) >= 1
    k = _kpis(mine, 2.0, 12.0)
    assert k == pytest.approx(_kpis(ref, 2.0, 12.0), rel=RTOL)
    assert 0.0 < k["mean_latency_s"] < 60.0 and k["mean_sessions"] >= 1


_FT_BASE = dict(duration_s=24.0, tick_s=0.5, monitor_interval_s=2.0,
                max_sessions=8, initial_sessions=4,
                session_arrival_per_s=0.3, mean_lifetime_s=40.0, seed=7)


def test_empty_failure_spec_is_bit_identical_and_matches_reference():
    plain = _sim(TE, _FT_BASE).run()
    wired_sim = _sim(TE, dict(_FT_BASE, failures=TE.FailureSpec(seed=9),
                              failure_handling=True))
    wired = wired_sim.run()
    assert wired_sim._hb is not None and wired_sim.orch.heartbeats is not None
    assert plain.session_log == wired.session_log
    for a, b in zip(plain.ticks, wired.ticks):
        assert np.array_equal(a.latencies, b.latencies)
        assert np.array_equal(a.node_rho, b.node_rho)
        assert (a.n_migrate, a.n_resplit) == (b.n_migrate, b.n_resplit)
        assert b.n_dead_nodes == 0 and b.preempted == 0
    _assert_same_run(wired, _sim(RE, dict(
        _FT_BASE, failures=RE.FailureSpec(seed=9),
        failure_handling=True)).run())


def _storm(mod):
    return dict(duration_s=30.0, tick_s=0.5, monitor_interval_s=2.0,
                max_sessions=8, initial_sessions=4,
                session_arrival_per_s=0.3, mean_lifetime_s=40.0, seed=7,
                failures=mod.FailureSpec(seed=3, blast_at_s=8.0,
                                         blast_nodes=(1, 2),
                                         blast_mttr_s=14.0),
                preempt_patience_s=20.0)


def test_cap8_storm_matches_reference():
    """tests/test_fault_tolerance.py's 30 s storm at cap 8: the blast kills
    MEC-1 and MEC-2 at 8 s for 14 s; every preemption, recovery and
    Eq. 4 overflow as the reference's."""
    sim_m, sim_r = _sim(TE, _storm(TE)), _sim(RE, _storm(RE))
    mine, ref = sim_m.run(), sim_r.run()
    _assert_same_run(mine, ref)
    assert any(m.n_dead_nodes == 2 for m in mine.ticks)
    assert [m.mem_violation_bytes for m in mine.ticks] == \
        [m.mem_violation_bytes for m in ref.ticks]
    assert mine.recovery_time_s(8.0) == ref.recovery_time_s(8.0)
    assert sim_m.admission.preempted_by_class == \
        sim_r.admission.preempted_by_class
    assert sim_m.admission.counters == sim_r.admission.counters


def _chaos(mod, handling, telemetry_rate=0.08):
    spec = mod.ChaosSpec(
        seed=3, crash_times=(8.0,), min_crash_spacing_s=5.0,
        rpc_fault_rate_per_s=0.08, rpc_fault_duration_s=3.0,
        rpc_drop_p=0.2, rpc_dup_p=0.15, rpc_delay_p=0.1,
        telemetry_rate_per_s=telemetry_rate, telemetry_duration_s=2.0)
    return dict(duration_s=20.0, tick_s=0.25, monitor_interval_s=0.5,
                max_sessions=8, initial_sessions=2,
                session_arrival_per_s=0.2, mean_lifetime_s=15.0,
                seed=11, admission=True, chaos=spec, chaos_handling=handling)


@pytest.mark.parametrize("telemetry_rate", [0.08, 0.3])
@pytest.mark.parametrize("handling", [False, True])
def test_chaos_mini_ab_matches_reference(handling, telemetry_rate, tmp_path):
    """tests/test_chaos.py's mini A/B: one crash at 8 s, transport faults,
    NaN telemetry (its rate, whose seed draws no event in 20 s, and 0.3 a
    second, which corrupts MEC-1 and MEC-2 four times).  ON restores the
    journal, fences the zombie and holds every invariant; OFF scrapes the
    data plane, lets the zombie commit and prices NaN telemetry verbatim."""
    sim_m = _sim(TE, _chaos(TE, handling, telemetry_rate),
                 journal=tmp_path / "port.npz")
    sim_r = _sim(RE, _chaos(RE, handling, telemetry_rate),
                 journal=tmp_path / "ref.npz")
    assert (sim_m._chaos.crash_times, sim_m._chaos.rpc_windows,
            sim_m._chaos.telemetry_events) == \
        (sim_r._chaos.crash_times, sim_r._chaos.rpc_windows,
         sim_r._chaos.telemetry_events)
    mine, ref = sim_m.run(), sim_r.run()
    _assert_same_run(mine, ref, sim_m, sim_r)
    assert [e for _, e in sim_m.invariants.violations] == \
        [e for _, e in sim_r.invariants.violations]
    assert [t for t, _ in sim_m.invariants.violations] == \
        [t for t, _ in sim_r.invariants.violations]
    assert sim_m.orch.broadcast._version == sim_r.orch.broadcast._version
    assert sim_m.chaos_stats["controller_restarts"] >= 1
    if handling:
        assert sim_m.invariants.violations == []
        assert sim_m.chaos_stats["zombie_committed"] == 0
        assert sim_m.chaos_stats["zombie_fenced"] == 1
        guard = sim_m.orch.telemetry_guard
        assert guard is not None
        assert guard.clamped_samples == \
            sim_r.orch.telemetry_guard.clamped_samples
        assert all(np.isfinite(m.latencies).all() for m in mine.ticks)
    else:
        assert sim_m.invariants.violations
        assert sim_m.chaos_stats["zombie_fenced"] == 0
        assert sim_m.orch.telemetry_guard is None
        # NaN telemetry priced verbatim: NaN latencies, counted as breaches
        poisoned = [m for m in mine.ticks if not np.isfinite(m.latencies).all()]
        assert bool(poisoned) == (telemetry_rate > 0.1)
        assert all(m.qos_violation_frac > 0 for m in poisoned)
    k = _kpis(mine, 0.0, 20.0)
    assert np.isfinite(k["mean_latency_s"])
    assert k == pytest.approx(_kpis(ref, 0.0, 20.0), rel=RTOL)


def test_chaos_off_arm_loses_the_version_counter(tmp_path):
    """tests/test_chaos.py::test_chaos_sim_off_arm_loses_state on the port:
    the scraped restart restarts the counter below the journaled one."""
    off = _sim(TE, _chaos(TE, False))
    on = _sim(TE, _chaos(TE, True), journal=tmp_path / "j.npz")
    off.run()
    on.run()
    assert off.chaos_stats["controller_restarts"] >= 1
    assert on.orch.broadcast._version >= off.orch.broadcast._version
    assert off.orch.device.type == on.orch.device.type == "cpu"


_REGIONS = dict(duration_s=12.0, max_sessions=12, initial_sessions=3,
                session_arrival_per_s=0.8, mean_lifetime_s=8.0, seed=11,
                n_regions=3)


def test_three_region_run_matches_reference():
    sim_m = _sim(TE, _REGIONS)
    assert isinstance(sim_m.orch, T.ShardedFleetOrchestrator)
    assert isinstance(sim_m.admission, T.ShardedFleetAdmissionController)
    assert sim_m.cfg.ingress_nodes == tuple(
        4 * r + i for r in range(3) for i in (0, 1, 2))
    mine, ref = sim_m.run(), _sim(RE, _REGIONS).run()
    _assert_same_run(mine, ref)
    regions = {e[2] >> 24 for e in mine.session_log if e[2] >= 0}
    assert len(regions) >= 2


@pytest.mark.parametrize("what", ["failures", "chaos"])
def test_sharding_refuses_injection(what):
    extra = ({"failures": TE.FailureSpec(seed=1)} if what == "failures"
             else {"chaos": TE.ChaosSpec(seed=1)})
    with pytest.raises(ValueError, match="n_regions > 1"):
        _sim(TE, dict(_REGIONS, **extra))


def _mini_orch(mod):
    n = 3
    bw = np.full((n, n), 1e9)
    np.fill_diagonal(bw, np.inf)
    state = mod.SystemState(
        flops_per_s=np.full(n, 1e13), mem_bytes=np.full(n, 40e9),
        background_util=np.full(n, 0.1), trusted=np.full(n, True),
        link_bw=bw, link_lat=np.full((n, n), 1e-3) * (1 - np.eye(n)),
        mem_bw=np.full(n, 5e11),
    )
    kw = {"device": "cpu"} if mod is T else {}
    return mod.FleetOrchestrator(
        profiler=mod.CapacityProfiler(base_state=state),
        broadcast=mod.ReconfigurationBroadcast(
            [mod.InProcessAgent(i) for i in range(n)]),
        thresholds=mod.Thresholds(cooldown_s=1.0), **kw)


def _tamper_sequence(mod, emod):
    """test_chaos.py::test_invariant_checker_clean_and_tampered's states,
    plus a resident row whose weight no longer matches its graph."""
    orch = _mini_orch(mod)
    g = mod.ModelGraph("m", [mod.GraphNode(f"u{i}", 2e10, 5e8, 8e3)
                             for i in range(6)])
    wl = mod.Workload(tokens_in=32, tokens_out=8, arrival_rate=0.5)
    sid = orch.admit(g, wl, now=0.0, qos=mod.QOS_STANDARD)
    orch.step(now=1.0)
    chk = emod.InvariantChecker()
    out = [chk.check(t=1.0, orch=orch, agents=orch.broadcast.agents)]
    agents = orch.broadcast.agents
    holder = next(a for a in agents if sid in a.active_by)
    other = next(a for a in agents if a is not holder)
    other.active_by[sid] = dataclasses.replace(
        holder.active_by[sid], version=holder.active_by[sid].version + 7)
    out.append(chk.check(t=2.0, orch=orch, agents=agents))
    del other.active_by[sid]
    holder.history.append(holder.history[-1])
    out.append(chk.check(t=3.0, orch=orch, agents=agents))
    holder.history.pop()
    # capacity conservation: one resident weight byte count off by 1 GB
    buf = orch._buffers
    row = buf.row_of[sid]
    saved = buf.seg_wbytes
    buf.seg_wbytes = saved.clone() if mod is T else np.array(saved)
    buf.seg_wbytes[row, 0] += 1e9
    out.append(chk.check(t=4.0, orch=orch, agents=agents))
    buf.seg_wbytes = saved
    out.append(chk.check(t=5.0, orch=orch, agents=agents))
    return out, chk.violations


def test_invariant_checker_flags_the_same_tampered_states():
    mine, rec_m = _tamper_sequence(T, TE)
    ref, rec_r = _tamper_sequence(R, RE)
    assert mine == ref and rec_m == rec_r
    assert mine[0] == [] and mine[-1] == []
    assert any("disagree" in e for e in mine[1])
    assert any("!= controller" in e for e in mine[1])
    assert any("non-monotone" in e for e in mine[2])
    assert any("resident row weight" in e for e in mine[3])


def test_invariant_checker_bounded_recording():
    orch = _mini_orch(T)
    chk = TE.InvariantChecker(max_recorded=3)
    orch.broadcast.agents[0].history.extend([5, 5, 5, 5, 5, 5])
    for t in range(10):
        chk.check(t=float(t), orch=orch, agents=orch.broadcast.agents)
    assert len(chk.violations) == 3


def _chaos_ab_on(mod):
    """benchmarks/fleet_scaling.py::chaos_ab's handling arm at its
    defaults (cap 32, 120 s, crashes at 30 and 75 s)."""
    spec = mod.ChaosSpec(
        seed=9, crash_rate_per_s=0.01, min_crash_spacing_s=20.0,
        crash_times=(30.0, 75.0), rpc_fault_rate_per_s=0.05,
        rpc_fault_duration_s=6.0, rpc_drop_p=0.2, rpc_dup_p=0.15,
        rpc_delay_p=0.1, telemetry_rate_per_s=0.04,
        telemetry_duration_s=4.0)
    return dict(duration_s=120.0, tick_s=0.25, monitor_interval_s=0.5,
                max_sessions=32, initial_sessions=8,
                session_arrival_per_s=32 / 90.0, mean_lifetime_s=40.0,
                seed=13, admission=True, chaos=spec, chaos_handling=True)


def test_chaos_ab_on_arm_leaves_reference_only_by_the_row_layout(
        tmp_path, monkeypatch):
    """The stated journal gap at chaos_ab's size: the port restores the
    resident row layout, the reference rebuilds the rows densely after the
    crash at 30 s, and the runs part at a later tick.  With the layout
    dropped from the port's journal (a dense rebuild, as the reference's)
    the port equals the reference tick for tick."""
    ref = _sim(RE, _chaos_ab_on(RE), journal=tmp_path / "ref.npz").run()
    mine = _sim(TE, _chaos_ab_on(TE), journal=tmp_path / "a.npz").run()
    assert mine.session_log != ref.session_log
    first = next(i for i, (a, b) in enumerate(zip(mine.ticks, ref.ticks))
                 if not _close(a.latencies, b.latencies))
    assert mine.ticks[first].t > 30.0
    dense = T.FleetOrchestrator.state_dict

    def without_layout(self, **kw):
        sd = dense(self, **kw)
        sd["resident"] = {}
        return sd

    monkeypatch.setattr(T.FleetOrchestrator, "state_dict", without_layout)
    sim_m = _sim(TE, _chaos_ab_on(TE), journal=tmp_path / "b.npz")
    _assert_same_run(sim_m.run(), ref)
    assert sim_m.chaos_stats["controller_restarts"] == 2
    assert sim_m.invariants.violations == []
