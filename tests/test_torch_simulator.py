"""The port's edge simulator against the reference, on the CPU.

The injectors' pre-drawn timelines and overlays, the §IV scenario's pieces
(the Llama-3-8B graph, the static split, the traces, the spike onsets), the
single-session ``EdgeSimulator`` static and adaptive at 20 and 200 Mb/s for
60 s (the adaptive arm's re-split DP on ``device="cpu"``) and
``SplitRevision(strategy="dp")``.  Timelines, per-tick latencies, node ρ and
decision streams are identical; Table II's bands hold on the port.
"""

import numpy as np
import pytest

import repro.edgesim as RE
import repro_torch.edgesim as TE
from repro.core import SplitRevision as RSplitRevision
from repro.core import Workload as RWorkload
from repro_torch.core import SplitRevision, Workload

_FAIL_SPECS = {
    "churn": dict(seed=5, mtbf_s=30.0, mttr_s=8.0, protected_nodes=(0,)),
    "blast": dict(seed=2, blast_at_s=20.0, blast_nodes=(1, 2),
                  blast_mttr_s=10.0),
    "flaps": dict(seed=7, flap_links=((0, 3), (1, 2)), flap_rate_per_s=0.05,
                  flap_duration_s=4.0, flap_bw_frac=0.05),
    "all": dict(seed=5, mtbf_s=30.0, mttr_s=8.0, blast_at_s=20.0,
                blast_nodes=(1, 2), blast_mttr_s=10.0,
                flap_links=((0, 3),), flap_rate_per_s=0.05),
}
_GRID = np.round(np.arange(0.0, 120.0, 0.5), 9)


def _state_eq(a, b):
    for f in ("flops_per_s", "mem_bytes", "background_util", "trusted",
              "link_bw", "link_lat", "mem_bw"):
        x, y = getattr(a, f), getattr(b, f)
        if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            return False
    return True


@pytest.mark.parametrize("kind", sorted(_FAIL_SPECS))
def test_failure_injector_matches_reference(kind):
    kw = _FAIL_SPECS[kind]
    ref = RE.FailureInjector(RE.FailureSpec(**kw), num_nodes=4,
                             horizon_s=120.0)
    mine = TE.FailureInjector(TE.FailureSpec(**kw), num_nodes=4,
                              horizon_s=120.0)
    assert mine._down == ref._down and mine._flaps == ref._flaps
    assert mine.any_failures == ref.any_failures is True
    st_r = RE.base_system_state(RE.MECScenarioParams())
    st_m = TE.base_system_state(TE.MECScenarioParams())
    before = st_m.copy()
    for t in _GRID:
        t = float(t)
        assert mine.dead_nodes(t) == ref.dead_nodes(t)
        assert mine.alive_nodes(t) == ref.alive_nodes(t)
        assert mine.flapped_links(t) == ref.flapped_links(t)
        out_m, out_r = mine.apply(st_m, t), ref.apply(st_r, t)
        assert _state_eq(out_m, out_r)
        quiet = not mine.dead_nodes(t) and not mine.flapped_links(t)
        assert (out_m is st_m) == quiet
    assert _state_eq(st_m, before)          # apply never mutates its input


def test_failure_injector_empty_spec_injects_nothing():
    mine = TE.FailureInjector(TE.FailureSpec(seed=0), num_nodes=4,
                              horizon_s=120.0)
    st = TE.base_system_state(TE.MECScenarioParams())
    assert not mine.any_failures
    assert mine.apply(st, 21.0) is st
    assert mine.alive_nodes(21.0) == (0, 1, 2, 3)


_CHAOS_SPECS = {
    "drawn": dict(seed=5, crash_rate_per_s=0.02, crash_times=(7.0,),
                  min_crash_spacing_s=5.0, rpc_fault_rate_per_s=0.1,
                  rpc_fault_duration_s=3.0, telemetry_rate_per_s=0.1,
                  telemetry_duration_s=2.0),
    "chaos_ab": dict(seed=9, crash_rate_per_s=0.01, min_crash_spacing_s=20.0,
                     crash_times=(30.0, 75.0), rpc_fault_rate_per_s=0.05,
                     rpc_fault_duration_s=6.0, telemetry_rate_per_s=0.04,
                     telemetry_duration_s=4.0),
    "pinned_nodes": dict(seed=3, crash_times=(8.0, 9.0, 30.0),
                         telemetry_rate_per_s=0.2, telemetry_nodes=(1, 3)),
}


@pytest.mark.parametrize("kind", sorted(_CHAOS_SPECS))
def test_chaos_injector_matches_reference(kind):
    kw = _CHAOS_SPECS[kind]
    ref = RE.ChaosInjector(RE.ChaosSpec(**kw), num_nodes=4, horizon_s=120.0)
    mine = TE.ChaosInjector(TE.ChaosSpec(**kw), num_nodes=4, horizon_s=120.0)
    assert mine.crash_times == ref.crash_times
    assert mine.rpc_windows == ref.rpc_windows
    assert mine.telemetry_events == ref.telemetry_events
    assert mine.telemetry_events, "the campaign must draw telemetry events"
    st_r = RE.base_system_state(RE.MECScenarioParams())
    st_m = TE.base_system_state(TE.MECScenarioParams())
    quiet_seen = corrupt_seen = False
    for t in _GRID:
        t = float(t)
        assert mine.rpc_fault_active(t) == ref.rpc_fault_active(t)
        assert mine.corrupted_nodes(t) == ref.corrupted_nodes(t)
        out_m = mine.corrupt(st_m, t)
        assert _state_eq(out_m, ref.corrupt(st_r, t))
        if mine.corrupted_nodes(t):
            corrupt_seen = True
            assert out_m is not st_m
            for n in mine.corrupted_nodes(t):
                assert np.isnan(out_m.background_util[n])
                assert np.isnan(np.delete(out_m.link_bw[n], n)).all()
        else:
            quiet_seen = True
            assert out_m is st_m            # the seed-paired fast path
    assert quiet_seen and corrupt_seen
    assert np.isfinite(st_m.background_util).all()


def test_llama_graph_and_static_split_match_reference():
    ref, mine = RE.llama3_8b_graph(), TE.llama3_8b_graph()
    assert mine.name == ref.name and len(mine) == len(ref)
    for a, b in zip(mine.nodes, ref.nodes):
        assert (a.name, a.flops, a.weight_bytes, a.act_out_bytes,
                a.privacy_critical) == (b.name, b.flops, b.weight_bytes,
                                        b.act_out_bytes, b.privacy_critical)
    assert TE.static_baseline_split(mine) == RE.static_baseline_split(ref)


@pytest.mark.parametrize("bw,seed", [(20.0, 0), (50.0, 3), (200.0, 11)])
def test_mec_traces_and_spike_onsets_match_reference(bw, seed):
    p_r = RE.MECScenarioParams(backhaul_mbps=bw, seed=seed)
    p_m = TE.MECScenarioParams(backhaul_mbps=bw, seed=seed)
    ut_r, bt_r = RE.mec_traces(p_r, 130.0)
    ut_m, bt_m = TE.mec_traces(p_m, 130.0)
    assert sorted(ut_m) == sorted(ut_r) and sorted(bt_m) == sorted(bt_r)
    grid = np.round(np.arange(0.0, 130.0, 0.1), 9)
    for k in ut_r:
        assert [ut_m[k](float(t)) for t in grid] == \
            [ut_r[k](float(t)) for t in grid]
    for k in bt_r:
        assert [bt_m[k](float(t)) for t in grid] == \
            [bt_r[k](float(t)) for t in grid]
    for dur in (10.0, 40.0, 60.0, 120.0, 180.0):
        assert TE.spike_onsets(p_m, dur) == RE.spike_onsets(p_r, dur)
    # apply_traces at a few instants: C(t) equal field for field
    from repro.edgesim.simulator import apply_traces as r_apply
    from repro_torch.edgesim.simulator import apply_traces as m_apply
    base_r, base_m = RE.base_system_state(p_r), TE.base_system_state(p_m)
    for t in (0.0, 9.9, 10.0, 33.3, 77.7):
        assert _state_eq(m_apply(base_m, ut_m, bt_m, t),
                         r_apply(base_r, ut_r, bt_r, t))


# --------------------------------------------------------------------------- #
# the single-session §IV simulator (Table II)
# --------------------------------------------------------------------------- #
_WINDOW = (20.0, 60.0)
_RUNS: dict = {}


def _run(mod, bw, adaptive):
    key = (mod.__name__, bw, adaptive)
    if key not in _RUNS:
        p = mod.MECScenarioParams(backhaul_mbps=bw, duration_s=60.0)
        kw = {"device": "cpu"} if mod is TE and adaptive else {}
        sim = mod.build_mec_scenario(p, adaptive=adaptive, **kw)
        _RUNS[key] = (sim, sim.run())
    return _RUNS[key]


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("bw", [20.0, 200.0])
def test_edge_simulator_tick_stream_matches_reference(bw, adaptive):
    _, ref = _run(RE, bw, adaptive)
    sim, mine = _run(TE, bw, adaptive)
    assert len(mine.ticks) == len(ref.ticks) == 600
    for a, b in zip(mine.ticks, ref.ticks):
        assert (a.t, a.arrivals, a.decision) == (b.t, b.arrivals, b.decision)
        assert a.latency_s == b.latency_s
        assert np.array_equal(a.node_rho, b.node_rho)
        assert (a.min_link_bw, a.completed) == (b.min_link_bw, b.completed)
    assert mine.reconfig_events == ref.reconfig_events
    if adaptive:
        assert _decisions(sim) == _decisions(_run(RE, bw, adaptive)[0])
    assert mine.kpis(*_WINDOW) == ref.kpis(*_WINDOW)


def _decisions(sim):
    """The monitoring cycles' decision stream: kind, split, version,
    reasons and Φ's predicted latency."""
    return [(d.kind.value, d.config.boundaries, d.config.assignment,
             d.config.version, d.reasons, d.predicted_latency_s)
            for d in sim.orch.decisions]


@pytest.mark.parametrize("bw,paper_static", [(20.0, 500), (50.0, 320),
                                             (100.0, 230), (200.0, 180)])
def test_port_static_latency_matches_table2(bw, paper_static):
    ours = _run(TE, bw, False)[1].kpis(*_WINDOW)["mean_latency_s"] * 1e3
    assert ours == pytest.approx(paper_static, rel=0.25), ours


def test_port_adaptive_bands_of_table2():
    """tests/test_edgesim_paper.py's claims, on the port: adaptive beats
    static with at least one reconfiguration, the gain at 20 Mb/s is the
    larger and above 0.45, URLLC's 155 ms holds adaptively at 200 Mb/s,
    and the cool-down spaces reconfigurations by 30 s."""
    gain = {}
    for bw in (20.0, 200.0):
        ks = _run(TE, bw, False)[1].kpis(*_WINDOW)
        res = _run(TE, bw, True)[1]
        ka = res.kpis(*_WINDOW)
        assert ka["mean_latency_s"] < ks["mean_latency_s"]
        assert len(res.reconfig_events) >= 1
        gain[bw] = 1 - ka["mean_latency_s"] / ks["mean_latency_s"]
        ts = [t for t, _, _ in res.reconfig_events]
        assert all(b - a >= 29.9 for a, b in zip(ts, ts[1:]))
    assert gain[20.0] > gain[200.0] and gain[20.0] > 0.45
    assert _run(TE, 200.0, True)[1].kpis(*_WINDOW)["mean_latency_s"] <= 0.155
    assert _run(TE, 200.0, False)[1].kpis(*_WINDOW)["mean_latency_s"] > 0.155


@pytest.mark.parametrize("bw", [20.0, 200.0])
def test_split_revision_dp_strategy_matches_reference(bw):
    """``strategy="dp"``: the DP's answer re-priced by Φ, no local search —
    the same boundaries and assignment as the reference's, cost to 1e-6."""
    wl_args = (56, 8, 4.0)
    st_r = RE.base_system_state(RE.MECScenarioParams(backhaul_mbps=bw))
    st_m = TE.base_system_state(TE.MECScenarioParams(backhaul_mbps=bw))
    st_r.background_util[0] = st_m.background_util[0] = 0.85
    ref = RSplitRevision(strategy="dp").revise(
        RE.llama3_8b_graph(), st_r, RWorkload(*wl_args))
    mine = SplitRevision(strategy="dp", device="cpu").revise(
        TE.llama3_8b_graph(), st_m, Workload(*wl_args))
    assert (mine.boundaries, mine.assignment) == \
        (ref.boundaries, ref.assignment)
    assert mine.cost == pytest.approx(ref.cost, rel=1e-6)
