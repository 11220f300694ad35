"""The port's admission controller against the reference, on the CPU.

Every scenario of tests/test_admission.py that needs no simulator runs
through both packages (the port with ``device="cpu"``): rho-ceiling reject
then admit after a departure, SLO reject, defer then admit on poll and
expiry, QoS thresholds carried, FIFO overflow, re-price under a changed
forecast, and depart while deferred at the cap; then ``preempt_overload`` on
dead-node states, the DEFER-on-rollout-error path through a ``FlakyAgent``
that drops everything, ``kpis()``, and a seed-paired arrival stream on the
§IV cluster with heartbeats, a two-node blast and transport faults.
Verdict kinds, sids, reasons, counters, queue order and eviction order are
identical; predicted latencies agree to 1e-12 relative.
"""

import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.admission as RA
import repro.core.splitter as RS
import repro.edgesim as RE
import repro_torch.core as T
import repro_torch.core.splitter as TS
import repro_torch.edgesim as TE
from repro.distributed.fault_tolerance import HeartbeatRegistry as RHeartbeats
from repro_torch.distributed import HeartbeatRegistry as THeartbeats

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


@functools.lru_cache(maxsize=None)
def _ref_parts():
    """Reference components shared by every reference fleet of the file, so
    each jitted program compiles once per shape."""
    return dict(splitter=R.BatchedJointSplitter(shared_units=32),
                evaluator=R.FleetCostEvaluator(),
                kernel=R.ResidentFleetKernel(),
                repairer=R.BatchedRepairPass())


def _ctrl_cls(mod):
    return RA.FleetAdmissionController if mod is R else T.FleetAdmissionController


def _parts(mod):
    return _ref_parts() if mod is R else {"device": "cpu"}


def _fleet(mod, n=2, util=0.1, agents=None, **kw):
    """tests/test_admission.py::_fleet through either package."""
    bw = np.full((n, n), 1e9)
    np.fill_diagonal(bw, np.inf)
    state = mod.SystemState(
        flops_per_s=np.full(n, 1e13),
        mem_bytes=np.full(n, 40e9),
        background_util=np.full(n, util),
        trusted=np.full(n, True),
        link_bw=bw,
        link_lat=np.full((n, n), 1e-3) * (1 - np.eye(n)),
        mem_bw=np.full(n, 5e11),
    )
    orch = mod.FleetOrchestrator(
        profiler=mod.CapacityProfiler(base_state=state),
        broadcast=mod.ReconfigurationBroadcast(
            agents if agents is not None
            else [mod.InProcessAgent(i) for i in range(n)]),
        thresholds=mod.Thresholds(cooldown_s=1.0),
        **_parts(mod), **kw,
    )
    return orch, state


def _graph(mod, units=6, flops=2e10, act_bytes=8e3, name="m", wbytes=5e8):
    return mod.ModelGraph(name, [
        mod.GraphNode(f"u{i}", flops, wbytes, act_bytes) for i in range(units)
    ])


def _heavy(mod):
    return _graph(mod, act_bytes=1e9), mod.Workload(48, 8, 1.2)


def _verdict(v):
    return (v.kind.value, v.sid, v.reason, v.predicted_latency_s)


def _queue(ctrl):
    return [(d, r.arch, r.source_node, r.qos.name, r.workload.arrival_rate,
             r.t_submit, r.preempted) for d, r, _ in ctrl._queue]


def _same(a, b):
    """Nested equality: floats to 1e-12 relative, everything else exact."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


def _assert_same_log(mine, ref):
    assert len(mine) == len(ref)
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert _same(m, r), (i, m, r)


# --------------------------------------------------------------------- #
# the reference's scenarios: each returns its event log
# --------------------------------------------------------------------- #
def rho_ceiling_then_departure(mod, monkeypatch):
    orch, _ = _fleet(mod)
    ctrl = _ctrl_cls(mod)(orch, max_sessions=16, rho_ceiling=1.0)
    patient = mod.QoSClass("patient", latency_slo_s=1e3, defer_timeout_s=0.0)
    g, wl = _heavy(mod)
    log = [_verdict(ctrl.request(mod_req(mod, g, wl, qos=patient), now=t))
           for t in (0.0, 1.0, 2.0)]
    assert [x[0] for x in log] == ["accept", "accept", "reject"]
    assert "rho" in log[2][2]
    orch.depart(log[1][1])
    log.append(_verdict(ctrl.request(mod_req(mod, g, wl, qos=patient),
                                     now=3.0)))
    assert log[-1][0] == "accept"
    return log + [dict(ctrl.counters)]


def slo_reject(mod, monkeypatch):
    orch, _ = _fleet(mod, util=0.3)
    ctrl = _ctrl_cls(mod)(orch, rho_ceiling=10.0)
    tight = mod.QoSClass("tight", latency_slo_s=1e-4, defer_timeout_s=0.0)
    v = ctrl.request(mod_req(mod, _graph(mod), mod.Workload(48, 8, 0.5),
                             qos=tight), now=0.0)
    assert v.kind.value == "reject" and "SLO" in v.reason
    assert v.predicted_latency_s > 1e-4
    return [_verdict(v), dict(ctrl.counters)]


def defer_then_poll_and_expire(mod, monkeypatch):
    orch, _ = _fleet(mod)
    ctrl = _ctrl_cls(mod)(orch, max_sessions=16, rho_ceiling=1.0)
    g, wl = _heavy(mod)
    q = mod.QoSClass("patient-q", latency_slo_s=1e3, defer_timeout_s=5.0)
    log = [_verdict(ctrl.request(mod_req(mod, g, wl, qos=q), now=0.0))
           for _ in range(2)]
    log += [_verdict(ctrl.request(mod_req(mod, g, wl, qos=q), now=1.0))
            for _ in range(2)]
    assert [x[0] for x in log] == ["accept"] * 2 + ["defer"] * 2
    log.append(_queue(ctrl))
    assert ctrl.poll(2.0) == []
    orch.depart(log[0][1])
    for t in (3.0, 7.0):
        log.append([_verdict(v) for _, v in ctrl.poll(t)])
        log.append(_queue(ctrl))
    assert [x[0] for x in log[-4]] == ["accept"]
    assert [x[0] for x in log[-2]] == ["reject"] and "timeout" in log[-2][0][2]
    assert ctrl.counters["expired"] == 1
    return log + [dict(ctrl.counters)]


def qos_thresholds_carried(mod, monkeypatch):
    orch, _ = _fleet(mod, util=0.2)
    ctrl = _ctrl_cls(mod)(orch, rho_ceiling=10.0)
    v = ctrl.request(mod_req(mod, _graph(mod), mod.Workload(32, 4, 0.5),
                             qos=mod.QOS_STANDARD), now=0.0)
    sess = orch.sessions[v.sid]
    assert sess.qos is mod.QOS_STANDARD
    th = orch._session_thresholds(sess)
    assert th.latency_max_s == mod.QOS_STANDARD.latency_slo_s
    return [_verdict(v), th.latency_max_s]


def fifo_overflow(mod, monkeypatch):
    orch, _ = _fleet(mod)
    ctrl = _ctrl_cls(mod)(orch, max_sessions=16, rho_ceiling=1.0, queue_cap=2)
    g, wl = _heavy(mod)
    q = mod.QoSClass("patient-q", latency_slo_s=1e3, defer_timeout_s=50.0)
    log = [_verdict(ctrl.request(mod_req(mod, g, wl, qos=q), now=0.0))
           for _ in range(2)]
    lam = [1.01, 1.02, 1.03]
    log += [_verdict(ctrl.request(mod_req(mod, g, mod.Workload(48, 8, lam[i]),
                                          qos=q), now=1.0 + i))
            for i in range(3)]
    assert [x[0] for x in log] == ["accept"] * 2 + ["defer", "defer", "reject"]
    log.append(_queue(ctrl))
    for sid in list(orch.sessions):
        orch.depart(sid)
    events = ctrl.poll(2.0)
    assert [r.workload.arrival_rate for r, _ in events] == lam[:2]
    log.append([_verdict(v) for _, v in events])
    return log + [dict(ctrl.counters)]


def reprice_under_forecast(mod, monkeypatch):
    orch, _ = _fleet(mod, n=2, util=0.1)
    dev = {} if mod is R else {"device": "cpu"}
    fc = mod.CapacityForecaster(mod.ForecastConfig(horizon_steps=2,
                                                   season_steps=8), **dev)

    def bg_at(t):
        return np.full(2, 0.9) if t % 8 in (4, 5) else np.full(2, 0.1)

    for t in range(16):
        fc.observe(float(t), bg_at(t))
    orch.forecaster = fc
    ctrl = _ctrl_cls(mod)(orch, max_sessions=16, rho_ceiling=1.0)
    q = mod.QoSClass("patient-q", latency_slo_s=1e3, defer_timeout_s=30.0)
    for t in (16, 17, 18):
        fc.observe(float(t), bg_at(t))
    g, wl = _heavy(mod)
    log = [_verdict(ctrl.request(mod_req(mod, g, wl, qos=q), now=18.0))]
    assert log[0][0] == "defer" and "forecast" in log[0][2]
    for t in (19, 20):
        fc.observe(float(t), bg_at(t))
    log.append([_verdict(v) for _, v in ctrl.poll(20.0)])
    for t in (21, 22):
        fc.observe(float(t), bg_at(t))
    log.append([_verdict(v) for _, v in ctrl.poll(22.0)])
    assert log == log[:1] + [[], log[2]] and log[2][0][0] == "accept"
    return log + [dict(ctrl.counters)]


def depart_while_deferred_at_cap(mod, monkeypatch):
    sp = RS if mod is R else TS
    orch, _ = _fleet(mod)
    ctrl = _ctrl_cls(mod)(orch, max_sessions=2, rho_ceiling=5.0)
    g, wl = _heavy(mod)
    q = mod.QoSClass("patient-q", latency_slo_s=1e3, defer_timeout_s=30.0)
    a = ctrl.request(mod_req(mod, g, wl, qos=q), now=0.0)
    b = ctrl.request(mod_req(mod, _graph(mod), mod.Workload(16, 4, 0.2),
                             qos=q), now=0.0)
    calls = {"pack": 0}
    real = sp.pack_problem

    def counting(*args, **kw):
        calls["pack"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(sp, "pack_problem", counting)
    v = ctrl.request(mod_req(mod, _graph(mod), mod.Workload(16, 4, 0.2),
                             qos=q), now=1.0)
    assert v.kind.value == "defer" and "cap" in v.reason
    assert calls["pack"] == 0
    assert ctrl.poll(2.0) == [] and calls["pack"] == 0
    orch.depart(a.sid)
    events = ctrl.poll(3.0)
    assert [x.kind.value for _, x in events] == ["accept"]
    assert calls["pack"] == 1
    return [_verdict(a), _verdict(b), _verdict(v),
            [_verdict(x) for _, x in events], dict(ctrl.counters)]


def rollout_error_defers(mod, monkeypatch):
    """Every prepare is dropped: the deploy aborts, the verdict is DEFER with
    the rollout error as its reason; once the transport heals the queued
    request is admitted on poll."""
    agents = [mod.FlakyAgent(mod.InProcessAgent(i), seed=3, drop_p=1.0)
              for i in range(2)]
    orch, _ = _fleet(mod, agents=agents)
    ctrl = _ctrl_cls(mod)(orch, max_sessions=16, rho_ceiling=1.0)
    q = mod.QoSClass("patient-q", latency_slo_s=1e3, defer_timeout_s=5.0)
    g, wl = _heavy(mod)
    log = [_verdict(ctrl.request(mod_req(mod, g, wl, qos=q), now=0.0))]
    assert log[0][0] == "defer" and "rollout failed" in log[0][2]
    assert orch._next_sid == 0 and not orch.sessions
    log.append([_verdict(v) for _, v in ctrl.poll(1.0)])
    assert log[-1] == []
    for a in agents:
        a.drop_p = 0.0
    log.append([_verdict(v) for _, v in ctrl.poll(2.0)])
    assert [x[0] for x in log[-1]] == ["accept"]
    log.append([dict(a.faults) for a in agents])
    log.append(dict(orch.broadcast.stats))
    return log + [ctrl.kpis()]


def mod_req(mod, graph, wl, **kw):
    cls = RA.AdmissionRequest if mod is R else T.AdmissionRequest
    return cls(graph, wl, **kw)


SCENARIOS = (rho_ceiling_then_departure, slo_reject,
             defer_then_poll_and_expire, qos_thresholds_carried,
             fifo_overflow, reprice_under_forecast,
             depart_while_deferred_at_cap, rollout_error_defers)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_admission_scenario_matches_reference(scenario, monkeypatch):
    ref = scenario(R, monkeypatch)
    monkeypatch.undo()
    mine = scenario(T, monkeypatch)
    _assert_same_log(mine, ref)


# --------------------------------------------------------------------- #
# preemption under overload
# --------------------------------------------------------------------- #
# (qos, home node) of the seeded sessions: interactive and standard
# tenants on node 1, batch tenants elsewhere — a dead node 1 first evicts a
# batch session fleet-wide; a dead node 2 evicts its own residents
_PREEMPT_MIX = (("interactive", 1), ("standard", 1), ("standard", 1),
                ("batch", 0), ("interactive", 2), ("batch", 2),
                ("standard", 2), (None, 2))


def _preempt_fleet(mod, dead, mem_frac, queue_cap):
    orch, state = _fleet(mod, n=3)
    ctrl = _ctrl_cls(mod)(orch, queue_cap=queue_cap, preempt_patience_s=30.0)
    for i, (qname, node) in enumerate(_PREEMPT_MIX):
        g = _graph(mod, name=f"m{i}", act_bytes=1e9, wbytes=2e9 + 1e8 * i)
        orch.admit(g, mod.Workload(16, 4, 0.2), source_node=node,
                   now=float(i), qos=None if qname is None
                   else mod.QOS_CLASSES[qname])
    st = state.copy()
    st.mem_bytes[dead] = mem_frac * st.mem_bytes[dead]
    return orch, ctrl, st


@pytest.mark.parametrize("dead,mem_frac,queue_cap",
                         [(1, 0.0, 16), (2, 0.0, 16), (2, 0.2, 1),
                          (0, 0.0, 16)])
def test_preempt_overload_matches_reference(dead, mem_frac, queue_cap):
    logs = []
    for mod in (R, T):
        orch, ctrl, st = _preempt_fleet(mod, dead, mem_frac, queue_cap)
        homes = {sid: s.config.assignment for sid, s in orch.sessions.items()}
        out = ctrl.preempt_overload(5.0, state=st)
        logs.append(([(s.sid, None if r is None else
                       (r.qos.name, r.preempted, r.t_submit))
                      for s, r in out],
                     _queue(ctrl), ctrl.kpis(), sorted(orch.sessions),
                     homes))
    mine, ref = logs
    assert mine == ref
    assert mine[0], "no session was preempted"


# --------------------------------------------------------------------- #
# a seed-paired stream on the §IV cluster: admission, heartbeats, a
# two-node blast, transport faults and preemption
# --------------------------------------------------------------------- #
STREAM_TICKS, BLAST = 14, (5.0, 11.0)


def _stream(mod, emod, seed=3):
    state = emod.base_system_state(emod.MECScenarioParams())
    n = state.num_nodes
    hb = (RHeartbeats if mod is R else THeartbeats)(list(range(n)))
    agents = [mod.FlakyAgent(mod.InProcessAgent(i), seed=9000 + i,
                             drop_p=0.2, dup_p=0.15, delay_p=0.1,
                             windows=((2.0, 5.0),)) for i in range(n)]
    dev = {} if mod is R else {"device": "cpu"}
    orch = mod.FleetOrchestrator(
        profiler=mod.CapacityProfiler(base_state=state),
        broadcast=mod.ReconfigurationBroadcast(agents),
        forecaster=mod.CapacityForecaster(
            mod.ForecastConfig(horizon_steps=8, season_steps=8), **dev),
        heartbeats=hb, **_parts(mod))
    ctrl = _ctrl_cls(mod)(orch, max_sessions=12, queue_cap=6,
                          preempt_patience_s=30.0)
    rng = np.random.default_rng(seed)
    catalog = emod.fleet_model_catalog()
    log = []
    for t in range(STREAM_TICKS):
        now = float(t)
        for a in agents:
            a.now = now
        st = state.copy()
        blast = BLAST[0] <= now < BLAST[1]
        if blast:
            for k in (1, 2):
                st.mem_bytes[k] = 0.0
                st.background_util[k] = 0.99
                st.link_bw[k, :] = 1.0
                st.link_bw[:, k] = 1.0
                st.link_bw[k, k] = np.inf
        orch.profiler.base_state = st
        for node in range(n):
            if not (blast and node in (1, 2)):
                hb.beat(node)
        log.append([_verdict(v) for _, v in ctrl.poll(now)])
        for _ in range(int(rng.poisson(2.0 if t else 6.0))):
            arch, g = catalog[int(rng.integers(len(catalog)))]
            wl = mod.Workload(int(rng.integers(16, 97)),
                              int(rng.integers(4, 17)),
                              float(rng.uniform(0.3, 2.0)))
            qos = mod.QOS_CLASSES[("interactive", "standard", "batch")[
                int(rng.choice(3, p=(0.2, 0.55, 0.25)))]]
            log.append(_verdict(ctrl.request(
                mod_req(mod, g, wl, source_node=int(rng.integers(3)),
                        arch=arch, qos=qos, t_submit=now), now=now)))
        if orch.sessions:
            fd = orch.step(now=now)
            log.append((fd.n_keep, fd.n_migrate, fd.n_resplit,
                        fd.n_node_fail, fd.dead_nodes, fd.infeasible_sids))
            log.append([(sid, d.kind.value, d.reasons)
                        for sid, d in fd.per_session.items()])
            if fd.infeasible_sids:
                log.append([(s.sid, r is None) for s, r in
                            ctrl.preempt_overload(now, state=st)])
        log.append(_queue(ctrl))
    log.append(ctrl.kpis())
    log.append([dict(a.faults) for a in agents])
    log.append({sid: (s.config.version, s.config.boundaries,
                      s.config.assignment) for sid, s in orch.sessions.items()})
    return log


def test_admission_stream_matches_reference():
    ref = _stream(R, RE)
    mine = _stream(T, TE)
    _assert_same_log(mine, ref)
    k = mine[-3]
    assert k["accepted"] > 0 and k["deferred"] + k["rejected"] > 0
    assert sum(sum(f.values()) for f in mine[-2]) > 0


def test_kpis_match_reference():
    """kpis() of a controller that accepted, deferred, rejected, expired and
    preempted: the same keys and values in both packages."""
    out = []
    for mod in (R, T):
        orch, ctrl, st = _preempt_fleet(mod, 1, 0.0, 16)
        ctrl.preempt_overload(5.0, state=st)
        q = mod.QoSClass("patient-q", latency_slo_s=1e3, defer_timeout_s=1.0)
        g, wl = _heavy(mod)
        tight = mod.QoSClass("tight", latency_slo_s=1e-4, defer_timeout_s=0.0)
        ctrl.request(mod_req(mod, _graph(mod), wl, qos=tight), now=6.0)
        for _ in range(3):
            ctrl.request(mod_req(mod, g, wl, qos=q), now=6.0)
        ctrl.poll(8.0)
        out.append(ctrl.kpis())
    assert list(out[0]) == list(out[1])
    assert out[0] == out[1]
    assert out[1]["rejected"] > 0 and out[1]["preempted"] > 0


def test_controller_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    state = TE.base_system_state(TE.MECScenarioParams())
    with pytest.raises(RuntimeError):
        T.FleetAdmissionController(T.FleetOrchestrator(
            profiler=T.CapacityProfiler(base_state=state),
            broadcast=T.ReconfigurationBroadcast(
                [T.InProcessAgent(i) for i in range(state.num_nodes)])))
