"""The port's crash journal and transport-fault wrapper, on the CPU.

A controller that crashes at cycle K and restores its journal into a fresh
orchestrator and admission controller resumes bit-identically to the run
that never crashed (sessions, configs, EWMAs, trigger contexts, the defer
queue, counters and verdicts; epochs aside).  Journals cross packages: the
reference's journal loaded into the port resumes to the reference's
uninterrupted decisions, and the port's loads into the reference.  Both
packages' ``state_dict`` metas have the same keys, integers and strings
exact, floats to 1e-12.  ``FlakyAgent``'s fault draws equal the reference's
bit for bit.
"""

import functools
import json

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.admission as RA
import repro.core.broadcast as RB
import repro_torch.core as T
import repro_torch.core.broadcast as TB
from repro.distributed.fault_tolerance import HeartbeatRegistry as RHeartbeats
from repro_torch.distributed import HeartbeatRegistry as THeartbeats

RTOL = 1e-12
K, N = 5, 12


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
    return dict(splitter=R.BatchedJointSplitter(shared_units=32),
                evaluator=R.FleetCostEvaluator(),
                kernel=R.ResidentFleetKernel(),
                repairer=R.BatchedRepairPass())


def _dev(mod):
    return {} if mod is R else {"device": "cpu"}


def _ctrl_cls(mod):
    return RA.FleetAdmissionController if mod is R else T.FleetAdmissionController


def _state(mod, n=3, util=0.1, seed=0):
    """tests/test_recovery.py::_state through either package."""
    rng = np.random.default_rng(seed)
    bw = np.full((n, n), 1e9)
    np.fill_diagonal(bw, np.inf)
    return mod.SystemState(
        flops_per_s=np.full(n, 1e13) * rng.uniform(0.9, 1.1, n),
        mem_bytes=np.full(n, 40e9),
        background_util=np.full(n, util),
        trusted=np.full(n, True),
        link_bw=bw,
        link_lat=np.full((n, n), 1e-3) * (1 - np.eye(n)),
        mem_bw=np.full(n, 5e11),
    )


def _graph(mod, units=6, flops=2e10, act_bytes=8e3, name="m"):
    return mod.ModelGraph(name, [
        mod.GraphNode(f"u{i}", flops, 5e8, act_bytes) for i in range(units)
    ])


def _orch(mod, *, forecast=True, agents=None, state=None):
    fc = None
    if forecast:
        fc = mod.CapacityForecaster(mod.ForecastConfig(
            horizon_steps=4, season_steps=8, sample_interval_s=1.0),
            **_dev(mod))
    parts = _ref_parts() if mod is R else {"device": "cpu"}
    hb = (RHeartbeats if mod is R else THeartbeats)([0, 1, 2])
    return mod.FleetOrchestrator(
        profiler=mod.CapacityProfiler(
            base_state=state if state is not None else _state(mod)),
        broadcast=mod.ReconfigurationBroadcast(
            agents if agents is not None
            else [mod.InProcessAgent(i) for i in range(3)]),
        thresholds=mod.Thresholds(cooldown_s=1.0),
        forecaster=fc, heartbeats=hb, **parts)


def _ctrl(mod, orch):
    return _ctrl_cls(mod)(orch, max_sessions=8, rho_ceiling=1.0, queue_cap=4)


def _boot(mod):
    orch = _orch(mod)
    for i in range(3):
        orch.admit(_graph(mod, name=f"m{i}"),
                   mod.Workload(32, 8, 0.4 + 0.1 * i), source_node=i % 2,
                   now=0.0, qos=mod.QOS_STANDARD)
    return orch, _ctrl(mod, orch)


def _restore(orch, path):
    """A fresh port orchestrator and controller over the surviving data
    plane, restored from the journal at ``path``."""
    o2 = T.FleetOrchestrator(
        profiler=T.CapacityProfiler(
            base_state=orch.profiler.base_state.copy()),
        broadcast=T.ReconfigurationBroadcast(
            orch.broadcast.agents, policy=orch.broadcast.policy),
        thresholds=orch.thresholds,
        forecaster=T.CapacityForecaster(orch.forecaster.cfg, device="cpu"),
        device="cpu")
    c2 = _ctrl(T, o2)
    o2.load(path, admission=c2, claim_epoch=True)
    return o2, c2


def _tick(mod, orch, ctrl, t):
    """One deterministic tick: node 0's background oscillates so triggers
    fire; every node but 2 beats (2 dies at cycle 8); sid 0 departs at 6;
    a heavy patient request arrives every other tick, so the defer queue
    fills, admits on poll and expires."""
    st = orch.profiler.base_state
    st.background_util[:] = 0.1
    st.background_util[0] = 0.92 if int(t) % 6 < 3 else 0.1
    for n in (0, 1, 2):
        if not (n == 2 and t >= 8):
            orch.heartbeats.beat(n)
    if t == 6 and 0 in orch.sessions:
        orch.depart(0)
    log = [[_verdict(v) for _, v in ctrl.poll(t)]]
    if int(t) % 2 == 0:
        patient = mod.QoSClass("patient", latency_slo_s=10.0,
                               defer_timeout_s=3.0)
        req = (RA.AdmissionRequest if mod is R else T.AdmissionRequest)(
            _graph(mod, act_bytes=1e9, name=f"a{int(t)}"),
            mod.Workload(48, 8, 1.2), source_node=int(t) % 3,
            arch=f"a{int(t)}", qos=patient, t_submit=t)
        log.append(_verdict(ctrl.request(req, now=t)))
    fd = orch.step(now=t)
    log.append((fd.n_keep, fd.n_migrate, fd.n_resplit, fd.n_node_fail,
                fd.dead_nodes, fd.infeasible_sids,
                [(sid, d.kind.value, d.reasons, d.predicted_latency_s)
                 for sid, d in fd.per_session.items()]))
    return log


def _verdict(v):
    return (v.kind.value, v.sid, v.reason, v.predicted_latency_s)


def _fingerprint(orch, ctrl):
    """Everything a resumed controller must agree on (epochs aside)."""
    sess = {}
    for sid, s in orch.sessions.items():
        sess[sid] = (
            s.config.version, s.config.boundaries, s.config.assignment,
            s.ewma_latency.value, s.t_last_reconfig,
            s.throttle.t_last, s.throttle.kinds, s.throttle.ewma,
        )
    queue = [(d, r.arch, r.qos.name, r.t_submit, r.preempted)
             for d, r, _ in ctrl._queue]
    return (sess, orch.broadcast._version, orch.degraded_cycles,
            dict(ctrl.counters), queue, orch.heartbeats.dead())


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


def _run(mod, orch, ctrl, cycles):
    out = []
    for i in cycles:
        log = _tick(mod, orch, ctrl, float(i))
        out.append((log, _fingerprint(orch, ctrl)))
    return out


@functools.lru_cache(maxsize=None)
def _uninterrupted(pkg):
    mod = R if pkg == "ref" else T
    orch, ctrl = _boot(mod)
    return _run(mod, orch, ctrl, range(N))


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [K, 9])
def test_crash_at_cycle_k_resumes_bit_identically(k, tmp_path):
    """Crash at cycle k with requests in the defer queue (at 9 also after a
    departure freed a row that a later admission took), restore into a fresh
    orchestrator and controller over the same agents: every later cycle is
    bit-identical to the run that never crashed."""
    want = _uninterrupted("port")
    b, cb = _boot(T)
    got = _run(T, b, cb, range(k))
    assert got == want[:k]
    assert cb.queued > 0, "the defer queue is empty at the crash"
    path = tmp_path / "journal.npz"
    b.save(path, admission=cb)
    b2, c2 = _restore(b, path)
    assert _fingerprint(b2, c2) == want[k - 1][1]
    assert all(pp is None for _, _, pp in c2._queue)
    assert b2.broadcast.epoch == b.broadcast.epoch + 1
    # the resident rows come back where the crashed controller had them
    for key, v in b._buffers.layout().items():
        np.testing.assert_array_equal(b2._buffers.layout()[key], v)
    _assert_same_rows(b2, b)
    got = _run(T, b2, c2, range(k, N))
    assert got == want[k:]
    counters = want[-1][1][3]
    for name in ("accepted", "deferred", "expired", "accepted_from_queue"):
        assert counters[name] > 0, name
    # the rows after the restored run equal those of the run that kept its
    # buffers, session for session
    a, ca = _boot(T)
    _run(T, a, ca, range(N))
    _assert_same_rows(b2, a)


def test_layout_after_churn_is_not_dense():
    """At cycle 9 a departure has left row 0 free, so a dense cold rebuild
    would shift every row (the fixed point colours rows by parity): the
    journal's layout is what the restore above relies on."""
    b, cb = _boot(T)
    _run(T, b, cb, range(9))
    row_sid = b._buffers.layout()["row_sid"]
    assert list(np.flatnonzero(row_sid >= 0)) != list(range(len(b.sessions)))


def _assert_same_rows(x, y):
    """Each session's resident row in ``x`` equals its row in ``y`` bit for
    bit (segment padding beyond the narrower buffer is zero)."""
    bx, by = x._resident(), y._resident()
    assert set(bx.row_of) == set(by.row_of)
    for name in ("seg_flops", "seg_wbytes", "seg_priv", "seg_node", "valid",
                 "xfer_bytes_tok", "n_segs", "t_in", "t_out", "lam",
                 "source", "input_bytes_tok", "active"):
        tx, ty = getattr(bx, name), getattr(by, name)
        for sid in bx.row_of:
            rx, ry = tx[bx.row_of[sid]], ty[by.row_of[sid]]
            if rx.dim():
                w = min(rx.numel(), ry.numel())
                assert not rx[w:].any() and not ry[w:].any(), (name, sid)
                rx, ry = rx[:w], ry[:w]
            assert torch.equal(rx, ry), (name, sid)


def test_port_uninterrupted_run_matches_reference():
    assert _same(_uninterrupted("port"), _uninterrupted("ref"))


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_journal_crosses_packages(direction, tmp_path):
    """A journal saved by one package at cycle K loads into a fresh
    orchestrator and controller of the other, which then resumes to the
    writer's uninterrupted run cycle by cycle."""
    src, dst = (R, T) if direction == "ref-to-port" else (T, R)
    want = _uninterrupted("ref" if src is R else "port")
    a, ca = _boot(src)
    _run(src, a, ca, range(K))
    path = tmp_path / "journal.npz"
    a.save(path, admission=ca)
    # the reader's own data plane, seeded with the writer's committed state
    agents = [dst.InProcessAgent(i) for i in range(3)]
    b = _orch(dst, agents=agents, state=_state(dst))
    cb = _ctrl(dst, b)
    b.load(path, admission=cb, claim_epoch=True, reseed_agents=True)
    assert _same(_fingerprint(b, cb), want[K - 1][1])
    got = _run(dst, b, cb, range(K, N))
    assert _same(got, want[K:])


def _flatten(x, prefix=""):
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(x, list):
        out = {f"{prefix}#": len(x)}
        for i, v in enumerate(x):
            out.update(_flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: x}


def test_state_dict_meta_matches_reference():
    metas, fcs = [], []
    for mod in (R, T):
        orch, ctrl = _boot(mod)
        _run(mod, orch, ctrl, range(K))
        sd = orch.state_dict(admission=ctrl)
        json.dumps(sd["meta"])
        metas.append(_flatten(sd["meta"]))
        fcs.append(sd["forecast"])
    ref, mine = metas
    assert list(mine) == list(ref)
    for k, r in ref.items():
        m = mine[k]
        if isinstance(r, float):
            assert isinstance(m, float) and _same(float(m), float(r)), \
                (k, m, r)
        else:
            assert type(m) is type(r) and m == r, (k, m, r)
    assert set(fcs[0]) == set(fcs[1])
    for k in fcs[0]:
        r, m = np.asarray(fcs[0][k]), np.asarray(fcs[1][k])
        assert r.dtype == m.dtype and r.shape == m.shape, k
        np.testing.assert_allclose(m, r, rtol=RTOL, atol=0)


def test_journal_roundtrip_preserves_state_dict(tmp_path):
    """save → load → state_dict is a fixed point (meta JSON-identical,
    forecast arrays exact)."""
    orch, ctrl = _boot(T)
    _run(T, orch, ctrl, range(K))
    path = tmp_path / "j.npz"
    orch.save(path, admission=ctrl)
    o2 = _orch(T)
    c2 = _ctrl(T, o2)
    o2.load(path, admission=c2, claim_epoch=False)
    d1, d2 = orch.state_dict(admission=ctrl), o2.state_dict(admission=c2)
    assert json.dumps(d1["meta"], sort_keys=True) == \
        json.dumps(d2["meta"], sort_keys=True)
    assert set(d1["forecast"]) == set(d2["forecast"])
    for k in d1["forecast"]:
        np.testing.assert_array_equal(d1["forecast"][k], d2["forecast"][k])
    assert set(d1["resident"]) == set(d2["resident"]) == {
        "row_sid", "free", "max_segs"}
    for k in d1["resident"]:
        np.testing.assert_array_equal(d1["resident"][k], d2["resident"][k])
    # the canonical QoS instances come back (identity feeds preemption)
    assert all(s.qos is T.QOS_STANDARD for s in o2.sessions.values()
               if s.qos.name == "standard")


def test_journal_rejects_unknown_schema_and_missing_forecaster(tmp_path):
    orch, ctrl = _boot(T)
    _run(T, orch, ctrl, range(2))
    sd = orch.state_dict(admission=ctrl)
    bad = {"meta": {**sd["meta"], "schema": "fleet-journal/v0"},
           "forecast": sd["forecast"]}
    with pytest.raises(ValueError, match="schema"):
        _orch(T).load_state_dict(bad)
    with pytest.raises(ValueError, match="forecaster"):
        _orch(T, forecast=False).load_state_dict(sd)


def test_save_is_atomic_and_leaves_no_temporary(tmp_path, monkeypatch):
    """A save that fails mid-write keeps the previous journal intact."""
    orch, ctrl = _boot(T)
    path = tmp_path / "j.npz"
    orch.save(path, admission=ctrl)
    before = path.read_bytes()
    _run(T, orch, ctrl, range(2))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        orch.save(path, admission=ctrl)
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["j.npz"]


def test_restart_while_deferred_keeps_queue(tmp_path):
    """tests/test_recovery.py's restart-while-deferred through both
    packages: the restored queue re-prices on poll and admits once the
    incumbent departs; verdicts identical."""
    logs = []
    for mod in (R, T):
        patient = mod.QoSClass("patient", latency_slo_s=10.0,
                               defer_timeout_s=1e3)
        heavy = mod.Workload(tokens_in=48, tokens_out=8, arrival_rate=1.2)
        req_cls = RA.AdmissionRequest if mod is R else T.AdmissionRequest

        def mk():
            orch = mod.FleetOrchestrator(
                profiler=mod.CapacityProfiler(base_state=_state(mod, 2)),
                broadcast=mod.ReconfigurationBroadcast(
                    [mod.InProcessAgent(i) for i in range(2)]),
                thresholds=mod.Thresholds(cooldown_s=1.0),
                **(_ref_parts() if mod is R else {"device": "cpu"}))
            return orch, _ctrl_cls(mod)(orch, rho_ceiling=1.0)

        orch, ctrl = mk()
        v1 = ctrl.request(req_cls(_graph(mod, act_bytes=1e9), heavy,
                                  qos=patient), now=0.0)
        v2 = ctrl.request(req_cls(_graph(mod, act_bytes=1e9, name="m2"),
                                  heavy, qos=patient), now=0.0)
        assert (v1.kind.value, v2.kind.value) == ("accept", "defer")
        path = tmp_path / f"{mod.__name__}.npz"
        orch.save(path, admission=ctrl)
        orch2, ctrl2 = mk()
        orch2.load(path, admission=ctrl2)
        assert ctrl2.queued == 1 and ctrl2.counters == ctrl.counters
        log = [_verdict(v1), _verdict(v2), ctrl2.poll(1.0)]
        orch2.depart(v1.sid)
        log.append([_verdict(v) for _, v in ctrl2.poll(2.0)])
        log.append(dict(ctrl2.counters))
        logs.append(log)
    assert logs[1][3][0][0] == "accept"
    assert _same(logs[1], logs[0])


def _guard_states(mod):
    clean = _state(mod, 3)
    bad = clean.copy()
    bad.background_util[1] = np.nan
    linky = clean.copy()
    linky.link_bw[2, :] = np.nan
    return clean, bad, linky


def _ran_guard(mod):
    """A guard that saw a clean sample, a NaN node and a NaN link row."""
    guard = mod.TelemetryGuard(staleness_budget_s=5.0)
    states = _guard_states(mod)
    for i, t in ((0, 0.0), (1, 1.0), (2, 2.0)):
        guard.sanitize(states[i], now=t)
    return guard


def test_telemetry_guard_roundtrip_matches_reference():
    """A guard restored from its state_dict (the port's or the reference's,
    through JSON) sanitizes the next samples exactly as the guard that kept
    running; the reference loads the port's too."""
    ref, mine = _ran_guard(R), _ran_guard(T)
    assert _same(_flatten(mine.state_dict()), _flatten(ref.state_dict()))
    assert mine.quarantined == ref.quarantined and mine.quarantined
    for src in (ref, mine):
        restored = T.TelemetryGuard()
        restored.load_state_dict(json.loads(json.dumps(src.state_dict())))
        kept = _ran_guard(T)
        assert restored.quarantined == kept.quarantined
        states = _guard_states(T)
        # within the budget, beyond it (degraded), then clean again
        for i, t in ((1, 4.0), (2, 9.0), (0, 10.0)):
            a = restored.sanitize(states[i], now=t)
            b = kept.sanitize(states[i], now=t)
            for f in ("background_util", "mem_bytes", "link_bw",
                      "flops_per_s", "mem_bw", "link_lat"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert restored.quarantined == kept.quarantined
        assert restored.clamped_samples == kept.clamped_samples
    r2 = R.TelemetryGuard()
    r2.load_state_dict(json.loads(json.dumps(mine.state_dict())))
    assert r2.quarantined == mine.quarantined
    assert r2.clamped_samples == mine.clamped_samples


# --------------------------------------------------------------------- #
# FlakyAgent
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 9, 9002, 2**40 + 7])
def test_flaky_agent_draws_match_reference(seed):
    """Over nodes, ops, versions and attempts, inside and outside the fault
    windows: the same fault sequence, counters and agent state."""
    windows = ((1.0, 3.0), (5.0, 6.5))
    for node in range(4):
        kw = dict(seed=seed, drop_p=0.2, dup_p=0.15, delay_p=0.1,
                  windows=windows)
        ref = RB.FlakyAgent(R.InProcessAgent(node), **kw)
        mine = TB.FlakyAgent(T.InProcessAgent(node), **kw)
        seq = []
        for now in np.arange(0.0, 7.0, 0.5):
            for agent in (ref, mine):
                agent.now = float(now)
            for version in range(1, 5):
                for op in ("prepare", "commit"):
                    for _ in range(3):
                        seq.append((ref._draw(op, version),
                                    mine._draw(op, version)))
        assert all(a == b for a, b in seq)
        assert {m for m, _ in seq} == {"ok", "drop", "dup", "delay"}
        assert ref._attempt == mine._attempt
        for v in range(6):
            u_r = RB._unit(seed, node, 1, v, 2)
            u_m = TB._unit(seed, node, 1, v, 2)
            assert u_r == u_m


def test_flaky_agent_rollouts_match_reference():
    """Rollouts through FlakyAgents under the default retry policy: the
    same committed configs, aborts, retries, fault counts and histories."""
    out = []
    for mod in (R, T):
        agents = [mod.FlakyAgent(mod.InProcessAgent(i), seed=9000 + i,
                                 drop_p=0.2, dup_p=0.15, delay_p=0.1)
                  for i in range(3)]
        bc = mod.ReconfigurationBroadcast(agents, policy=mod.RolloutPolicy())
        log = []
        for v in range(12):
            cfg = bc.rollout((0, 2, 4), (v % 3, (v + 1) % 3), now=float(v),
                             session=v % 2)
            log.append(None if cfg is None else (cfg.version, cfg.assignment))
        log.append(dict(bc.stats))
        log.append([(dict(a.faults), a.history, sorted(a.active_by))
                    for a in agents])
        out.append(log)
    assert _same(out[1], out[0])
    assert out[1][-2]["aborts"] + out[1][-2]["retries"] > 0
