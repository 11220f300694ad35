"""The port's fleet orchestrator against the reference, on the CPU.

``BatchedJointSplitter`` is held against the reference's batched splitter
and the brute-force oracle; ``fleet_model_catalog`` against the reference's
graphs; and seed-paired ``FleetOrchestrator`` runs go through both packages
(the port with ``device="cpu"``) — fixed point on and off, forecast on, a
heartbeat node failure and NaN telemetry (guarded and unguarded) — with every
``FleetDecision`` field, every per-session decision and every session config
identical cycle by cycle, and priced latencies equal to 1e-12 relative.
"""

import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as R
import repro.edgesim as RE
import repro_torch.core as T
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


# --------------------------------------------------------------------- #
# batched joint splitter and the model catalog
# --------------------------------------------------------------------- #
def _random_state(mod, seed, n_nodes=3):
    rng = np.random.default_rng(seed)
    bw = rng.uniform(1e6, 1e8, (n_nodes, n_nodes))
    bw = (bw + bw.T) / 2
    np.fill_diagonal(bw, np.inf)
    trusted = rng.random(n_nodes) < 0.6
    trusted[0] = True
    return mod.SystemState(
        flops_per_s=rng.uniform(1e12, 1e14, n_nodes),
        mem_bytes=rng.uniform(5e8, 5e9, n_nodes),
        background_util=rng.uniform(0.0, 0.8, n_nodes),
        trusted=trusted,
        link_bw=bw,
        link_lat=np.full((n_nodes, n_nodes), 4e-3) * (1 - np.eye(n_nodes)),
        mem_bw=rng.uniform(1e11, 2e12, n_nodes),
    )


def _problems(mod, seed, count, depth, n_nodes=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        L = depth if depth else int(rng.integers(3, 8))
        units = [
            mod.GraphNode(f"u{i}", flops=float(rng.uniform(1e8, 2e9)),
                          weight_bytes=float(rng.uniform(1e7, 5e8)),
                          act_out_bytes=float(rng.uniform(1e3, 2e4)),
                          privacy_critical=bool(rng.random() < 0.3 or i == 0))
            for i in range(L)
        ]
        wl = mod.Workload(tokens_in=int(rng.integers(8, 128)),
                          tokens_out=int(rng.integers(1, 32)),
                          arrival_rate=float(rng.uniform(0.1, 8.0)))
        out.append(mod.SessionProblem(mod.ModelGraph("rand", units), wl,
                                      source_node=int(rng.integers(0, n_nodes))))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shared_units", [None, 4])
def test_batched_splitter_matches_reference(seed, shared_units):
    """Mixed-depth buckets (and the shared-units coarsening) give the
    reference's boundaries and assignments; costs agree to float32."""
    mine = T.BatchedJointSplitter(shared_units=shared_units, device="cpu")
    ref = R.BatchedJointSplitter(shared_units=shared_units)
    sols = mine.solve_batch(_problems(T, seed, 6, 0), _random_state(T, seed))
    want = ref.solve_batch(_problems(R, seed, 6, 0), _random_state(R, seed))
    for s, w in zip(sols, want):
        assert (s.boundaries, s.assignment) == (w.boundaries, w.assignment)
        assert s.cost == pytest.approx(w.cost, rel=1e-6)
    # the batched pass equals the single-session device DP row for row
    single = T.TorchJointSplitter(device="cpu")
    for p, s in zip(_problems(T, seed, 6, 0), sols):
        one = single.solve(p.graph, _random_state(T, seed), p.workload,
                           source_node=p.source_node,
                           max_units=mine.units_for(len(p.graph), None))
        assert (one.boundaries, one.assignment) == (s.boundaries, s.assignment)


@pytest.mark.parametrize("seed", range(4))
def test_batched_splitter_is_exact_on_the_surrogate(seed):
    state = _random_state(T, seed + 1)
    probs = _problems(T, seed, 3, 4)
    sols = T.BatchedJointSplitter(device="cpu").solve_batch(probs, state)
    for p, sol in zip(probs, sols):
        bf = T.brute_force_joint(p.graph, state, p.workload,
                                 source_node=p.source_node)
        sc = T.surrogate_cost(p.graph, sol.boundaries, sol.assignment, state,
                              p.workload, source_node=p.source_node)
        assert sc == pytest.approx(bf.cost, rel=1e-6)
        rbf = R.brute_force_joint(
            _problems(R, seed, 3, 4)[probs.index(p)].graph,
            _random_state(R, seed + 1), p.workload, source_node=p.source_node)
        assert bf.cost == pytest.approx(rbf.cost, rel=RTOL)


def test_fleet_model_catalog_matches_reference():
    mine, ref = TE.fleet_model_catalog(), RE.fleet_model_catalog()
    assert [a for a, _ in mine] == [a for a, _ in ref]
    for (_, g), (_, h) in zip(mine, ref):
        assert g.name == h.name and len(g) == len(h)
        for name in ("flops", "weight_bytes", "act_out_bytes", "privacy"):
            np.testing.assert_array_equal(getattr(g, name), getattr(h, name))


# --------------------------------------------------------------------- #
# seed-paired orchestrator runs
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _ref_parts():
    """Reference components shared by every reference fleet of the file, so
    each jitted program compiles once per shape."""
    return dict(splitter=R.BatchedJointSplitter(shared_units=32),
                evaluator=R.FleetCostEvaluator(),
                kernel=R.ResidentFleetKernel(),
                repairer=R.BatchedRepairPass())


N_SESSIONS, CYCLES, FAILED_NODE, FAIL_AT = 8, 12, 1, 2
NAN_NODE, NAN_CYCLES = 2, range(3, 6)
SPIKE = (0.35, 0.85)      # home-MEC background: base, saturation (forecast)


def _fleet(mod, emod, arm, **extra):
    """The reference benchmark's saturated fleet, at 8 sessions."""
    state = emod.base_system_state(emod.MECScenarioParams())
    dev = {"device": "cpu"} if mod is T else {}
    fc = None
    if arm == "forecast":
        fc = mod.CapacityForecaster(mod.ForecastConfig(
            horizon_steps=8, season_steps=8), **dev)
    hb = None
    if arm == "node-fail":
        hb = (THeartbeats if mod is T else RHeartbeats)(
            list(range(state.num_nodes)))
    kw = dict(extra)
    if arm == "nan-unguarded":
        kw["telemetry_guard"] = None
    orch = mod.FleetOrchestrator(
        profiler=mod.CapacityProfiler(base_state=state),
        broadcast=mod.ReconfigurationBroadcast(
            [mod.InProcessAgent(i) for i in range(state.num_nodes)]),
        thresholds=mod.Thresholds(cooldown_s=0.5),
        solve_backoff_s=0.0, forecaster=fc, heartbeats=hb,
        use_fixed_point=arm != "greedy", **dev, **kw)
    rng = np.random.default_rng(0)
    catalog = emod.fleet_model_catalog()
    for _ in range(N_SESSIONS):
        _, graph = catalog[int(rng.integers(len(catalog)))]
        wl = mod.Workload(tokens_in=int(rng.integers(32, 96)),
                          tokens_out=int(rng.integers(8, 16)),
                          arrival_rate=float(rng.uniform(2.0, 5.0)))
        orch.admit(graph, wl, source_node=int(rng.integers(0, 3)), now=0.0)
    return orch


def _before_cycle(orch, arm, c):
    """The arm's environment for cycle ``c``: heartbeats, NaN telemetry, a
    periodic home-MEC saturation the forecaster learns in one season."""
    if arm == "forecast":
        orch.profiler.base_state.background_util[0] = \
            SPIKE[1] if c % 8 in (5, 6) else SPIKE[0]
    if orch.heartbeats is not None:
        for node in orch.heartbeats.nodes:
            if not (node == FAILED_NODE and c >= FAIL_AT):
                orch.heartbeats.beat(node)
    if arm.startswith("nan"):
        base = orch.profiler.base_state
        if c == NAN_CYCLES[0]:
            orch._saved_util = base.background_util[NAN_NODE]
            base.background_util[NAN_NODE] = np.nan
        elif c == NAN_CYCLES[-1] + 1:
            base.background_util[NAN_NODE] = orch._saved_util


_FD_FIELDS = ("t", "n_keep", "n_migrate", "n_resplit", "n_cooldown",
              "n_preempt", "n_node_fail", "dead_nodes", "infeasible_sids",
              "n_conflict_keep", "n_nogain_keep", "fixed_point_sweeps",
              "fixed_point_aborts")


def _cfg(c):
    return None if c is None else (c.version, c.boundaries, c.assignment,
                                   c.reason, c.issued_at, c.session, c.epoch)


def _close(a, b):
    return a == b or (np.isnan(a) and np.isnan(b)) or \
        abs(a - b) <= RTOL * max(abs(a), abs(b))


def _assert_same_cycle(fm, fr, c):
    for f in _FD_FIELDS:
        assert getattr(fm, f) == getattr(fr, f), (c, f)
    assert list(fm.per_session) == list(fr.per_session), c
    for sid, dr in fr.per_session.items():
        dm = fm.per_session[sid]
        assert dm.kind.value == dr.kind.value, (c, sid)
        assert dm.reasons == dr.reasons, (c, sid)
        assert _cfg(dm.config) == _cfg(dr.config), (c, sid)
        assert _close(dm.predicted_latency_s, dr.predicted_latency_s), (c, sid)
        assert dm.solver_time_s == dr.solver_time_s


def _assert_same_sessions(mine, ref):
    assert list(mine.sessions) == list(ref.sessions)
    for sid, sr in ref.sessions.items():
        sm = mine.sessions[sid]
        assert _cfg(sm.config) == _cfg(sr.config), sid
        assert sm.t_last_reconfig == sr.t_last_reconfig
        er, em = sr.ewma_latency.value, sm.ewma_latency.value
        assert (er is None and em is None) or _close(em, er), sid
        assert (sm.throttle.t_last, sm.throttle.kinds) == \
            (sr.throttle.t_last, sr.throttle.kinds)


ARMS = ("fixed-point", "greedy", "forecast", "node-fail", "nan-guarded",
        "nan-unguarded")


@pytest.mark.parametrize("arm", ARMS)
def test_orchestrator_matches_reference_cycle_by_cycle(arm):
    ref = _fleet(R, RE, arm, **_ref_parts())
    mine = _fleet(T, TE, arm)
    _assert_same_sessions(mine, ref)
    for c in range(CYCLES):
        _before_cycle(ref, arm, c)
        _before_cycle(mine, arm, c)
        fr = ref.step(now=float(c))
        fm = mine.step(now=float(c))
        _assert_same_cycle(fm, fr, c)
        _assert_same_sessions(mine, ref)
    assert mine.degraded_cycles == ref.degraded_cycles
    if arm == "node-fail":
        assert any(d.n_node_fail for d in mine.decisions)
        assert FAILED_NODE in mine.decisions[-1].dead_nodes
    if arm == "nan-guarded":
        assert mine.telemetry_guard.clamped_samples == \
            ref.telemetry_guard.clamped_samples > 0
    if arm == "nan-unguarded":
        assert mine.degraded_cycles > 0
    if arm == "forecast":
        assert mine.forecaster.ready
        # the learned spike is inside the horizon: the worst case sees it
        assert mine.forecaster.bg_wc[0] == pytest.approx(SPIKE[1])
        np.testing.assert_allclose(mine.forecaster.bg_wc,
                                   ref.forecaster.bg_wc, rtol=RTOL)
    # the resident rows after all the commits equal the reference's
    buf_m, buf_r = mine._buffers, ref._buffers
    assert buf_m.row_of == buf_r.row_of
    for name in ("seg_node", "n_segs", "valid", "seg_flops", "seg_wbytes"):
        np.testing.assert_array_equal(getattr(buf_m, name).numpy(),
                                      np.asarray(getattr(buf_r, name)))


def test_depart_and_price_fleet_match_reference():
    ref = _fleet(R, RE, "fixed-point", **_ref_parts())
    mine = _fleet(T, TE, "fixed-point")
    for orch in (ref, mine):
        orch.step(now=0.0)
        orch.depart(3)
        orch.depart(5)
    sm, lm, tm = mine.price_fleet(now=1.0)
    sr, lr, tr = ref.price_fleet(now=1.0)
    assert sm == sr
    np.testing.assert_allclose(lm, lr, rtol=RTOL)
    np.testing.assert_allclose(tm, tr, rtol=RTOL)
    fm, fr = mine.step(now=2.0), ref.step(now=2.0)
    _assert_same_cycle(fm, fr, 2)
    state = mine.profiler.system_state()
    per, tot_n, tot_l, tot_w = mine.resident_table(state, include=(0,))
    _, tot_n2, tot_l2, tot_w2 = mine.load_table(state)
    np.testing.assert_allclose(tot_n, tot_n2, rtol=1e-12)
    np.testing.assert_allclose(tot_l, tot_l2, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(tot_w, tot_w2, rtol=1e-12)


def test_orchestrator_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    state = TE.base_system_state(TE.MECScenarioParams())
    with pytest.raises(RuntimeError):
        T.FleetOrchestrator(
            profiler=T.CapacityProfiler(base_state=state),
            broadcast=T.ReconfigurationBroadcast(
                [T.InProcessAgent(i) for i in range(state.num_nodes)]))
