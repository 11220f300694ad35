"""The port's region-sharded fleet against the reference, on the CPU.

``region_slice`` and ``regional_system_state`` are held against the
reference bit for bit; the cross-shard screen against the port's per-shard
``ResidentFleetKernel.price`` (1e-12) after a clean restack, one dirty shard
and more than a quarter dirty, with a quiet screen re-uploading nothing; and
the reference's three sharded contracts run through both packages (the port
with ``device="cpu"``): one region bit-identical to a bare
``FleetOrchestrator`` with the sid sequence shared, session conservation
under seed-paired churn at 3 regions, and one pricing call per shard per
quiet cycle plus one screen, pack-free, with the forecaster and
``CalibratedCostModel`` on.  Then the cross-region drill, a cross move whose
target rollout is refused, and ``ShardedFleetAdmissionController``.
Decisions, sids and regions are identical; floats agree to 1e-12 relative.
"""

import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.fleet as RF
import repro.edgesim as RE
import repro_torch.core as T
import repro_torch.edgesim as TE
from repro.distributed.fault_tolerance import HeartbeatRegistry as RHeartbeats
from repro_torch.distributed import HeartbeatRegistry as THeartbeats

RTOL = 1e-12
_ROW_FIELDS = ("seg_flops", "seg_wbytes", "seg_priv", "seg_node", "valid",
               "xfer_bytes_tok", "n_segs", "t_in", "t_out", "lam", "source",
               "input_bytes_tok", "active")
_DECISION_COUNTS = ("n_keep", "n_migrate", "n_resplit", "n_cooldown",
                    "n_conflict_keep", "n_nogain_keep", "fixed_point_sweeps",
                    "fixed_point_aborts", "n_preempt", "n_node_fail",
                    "dead_nodes", "infeasible_sids")


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


def _edge(mod):
    return RE if mod is R else TE


@functools.lru_cache(maxsize=None)
def _ref_parts():
    """Reference components shared by the inners of every reference fleet
    of the file, so each jitted program compiles once per shape."""
    return dict(splitter=R.BatchedJointSplitter(shared_units=32),
                evaluator=R.FleetCostEvaluator(),
                kernel=R.ResidentFleetKernel(),
                repairer=R.BatchedRepairPass())


def _share_parts(orch):
    """Swap a reference orchestrator's components for the shared ones."""
    for name, part in _ref_parts().items():
        setattr(orch, name, part)
        if name != "repairer":
            part.cost_model = orch.cost_model
    return orch


def _regional(mod, n_regions, **kw):
    """``build_regional_orchestrator`` of either package (the port on the
    CPU; the reference's inners on the shared components)."""
    m = _edge(mod).MECScenarioParams()
    if mod is T:
        return TE.build_regional_orchestrator(m, n_regions, device="cpu",
                                              **kw)
    w = RE.build_regional_orchestrator(m, n_regions, **kw)
    for o in w.inners:
        _share_parts(o)
    return w


def _mono(mod):
    state = _edge(mod).base_system_state(_edge(mod).MECScenarioParams())
    orch = mod.FleetOrchestrator(
        profiler=mod.CapacityProfiler(base_state=state),
        broadcast=mod.ReconfigurationBroadcast(
            [mod.InProcessAgent(i) for i in range(state.num_nodes)]),
        thresholds=mod.Thresholds(cooldown_s=10.0),
        weights=mod.CostWeights(alpha=1.0, beta=0.02, gamma=1000.0),
        **({"device": "cpu"} if mod is T else {}))
    return orch if mod is T else _share_parts(orch)


def _tiny_graph(mod, layers, name):
    return mod.make_transformer_graph(
        name=name, num_layers=layers, d_model=256,
        flops_per_layer_token=4e9, weight_bytes_per_layer=3e8,
        embed_weight_bytes=1e8, head_weight_bytes=1e8, head_flops_token=2e8)


def _catalog(mod):
    return [("tiny-a", _tiny_graph(mod, 8, "tiny-a")),
            ("tiny-b", _tiny_graph(mod, 12, "tiny-b"))]


def _qos(mod):
    return (mod.QOS_INTERACTIVE, mod.QOS_STANDARD, mod.QOS_BATCH)


def _decision(d):
    """A FleetDecision as plain data (latencies as floats)."""
    return ([getattr(d, f) for f in _DECISION_COUNTS],
            [(sid, x.kind.value, x.reasons,
              None if x.config is None else (x.config.boundaries,
                                             x.config.assignment),
              float(x.predicted_latency_s))
             for sid, x in sorted(d.per_session.items())])


def _same(a, b):
    """Nested equality: floats to 1e-12 relative, everything else exact."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b)) or (
            np.isnan(a) and np.isnan(b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            return np.allclose(b, a, rtol=RTOL, atol=0, equal_nan=True)
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


def _assert_same_log(mine, ref):
    assert len(mine) == len(ref)
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert _same(m, r), (i, m, r)


def _rows(buf):
    """{sid: (field -> host row)} for every live resident row."""
    return {sid: {f: getattr(buf, f)[row].cpu().numpy()
                  if isinstance(getattr(buf, f), torch.Tensor)
                  else np.asarray(getattr(buf, f))[row]
                  for f in _ROW_FIELDS}
            for sid, row in buf.row_of.items()}


def _layout(buf):
    """Where each row lies (``FleetStateBuffers.layout`` of the port, built
    by hand so that the reference's buffers give it too)."""
    row_sid = np.full(buf.n_rows, -1, dtype=np.int64)
    for sid, r in buf.row_of.items():
        row_sid[r] = sid
    return {"row_sid": row_sid, "free": np.asarray(buf._free, dtype=np.int64),
            "max_segs": np.asarray(buf.max_segs)}


def _assert_conserved(w, alive):
    """Every live session in exactly one shard; rows mirror sessions."""
    seen = {}
    for r, o in enumerate(w.inners):
        for sid in o.sessions:
            assert sid not in seen, (sid, seen[sid], r)
            seen[sid] = r
        if o._buffers is not None:
            assert set(o._buffers.row_of) == set(o.sessions)
            assert int(np.asarray(o._buffers.active).sum()) == len(o.sessions)
    assert set(seen) == alive


# --------------------------------------------------------------------- #
# regions in C(t)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_regions", [1, 3, 5])
def test_regional_state_and_region_slice_match_reference(n_regions):
    mine = TE.regional_system_state(TE.MECScenarioParams(), n_regions)
    ref = RE.regional_system_state(RE.MECScenarioParams(), n_regions)
    assert mine.num_regions == ref.num_regions == n_regions
    assert mine.names == ref.names
    for f in ("flops_per_s", "mem_bytes", "background_util", "trusted",
              "link_bw", "link_lat", "mem_bw", "region_of"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(mine.copy().region_of, ref.region_of)
    for r in range(n_regions):
        ix = np.where(ref.region_of == r)[0]
        a, b = T.region_slice(mine, ix), R.region_slice(ref, ix)
        assert a.region_of is None and b.region_of is None
        assert a.names == b.names and a.num_regions == 1
        for f in ("flops_per_s", "mem_bytes", "background_util", "trusted",
                  "link_bw", "link_lat", "mem_bw"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("region_of", [[0, 0, 2, 2], [1, 1, 2, 2], [0, 1, 0]])
def test_bad_region_ids_are_refused_like_the_reference(region_of):
    for mod in (R, T):
        st = _edge(mod).base_system_state(_edge(mod).MECScenarioParams())
        with pytest.raises(ValueError):
            mod.SystemState(st.flops_per_s, st.mem_bytes, st.background_util,
                            st.trusted, st.link_bw, st.link_lat, st.mem_bw,
                            region_of=np.asarray(region_of))


# --------------------------------------------------------------------- #
# the cross-shard screen
# --------------------------------------------------------------------- #
def _assert_screen_is_price(w):
    """Row block s of one screen == the port's price on shard s (1e-12)."""
    sh = w._sharded()
    states = [o.profiler.system_state() for o in w.inners]
    scr = sh.screen(states, weights=w.inners[0].weights,
                    bw_floor=w.inners[0].bw_floor_frac)
    for s, o in enumerate(w.inners):
        p = o.kernel.price(o._buffers, states[s], weights=o.weights,
                           bw_floor=o.bw_floor_frac)
        for name in ("lat", "max_util", "min_bw", "tot_node", "tot_w"):
            want = getattr(p, name).numpy()
            got = getattr(scr, name)[s]
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                       err_msg=f"shard {s} {name}")
    return sh, scr


def test_screen_equals_per_shard_price_as_the_row_block_refreshes():
    w = _regional(T, 4)
    g = _catalog(T)[0][1]
    for r, count in enumerate((3, 1, 2, 5)):
        for i in range(count):
            w.admit(g, T.Workload(24 + 4 * i, 6, 0.4 + 0.1 * r),
                    source_node=4 * r + i % 3, now=0.0)
    for r, o in enumerate(w.inners):
        o.profiler.base_state.background_util[:3] = 0.2 + 0.15 * r
    # cold: every shard dirty, one full restack
    sh, _ = _assert_screen_is_price(w)
    stack = sh._stack
    # a quiet screen re-uploads nothing: the block's tensors are the same
    # objects and none was written in place
    versions = [t._version for t in stack]
    _assert_screen_is_price(w)
    assert sh._stack is stack and [t._version for t in stack] == versions
    # one dirty shard (<= max(1, S // 4)): one in-place copy into its slice
    w.admit(g, T.Workload(40, 7, 0.9), source_node=9, now=1.0)
    _assert_screen_is_price(w)
    assert sh._stack is stack
    assert [t._version for t in stack] == [v + 1 for v in versions]
    # two dirty shards (> S // 4): a full restack
    w.admit(g, T.Workload(20, 5, 0.6), source_node=1, now=2.0)
    w.depart(max(w.inners[3].sessions))
    _assert_screen_is_price(w)
    assert sh._stack is not stack
    assert all(a is not b for a, b in zip(sh._stack, stack))
    assert sh.screen_dispatches == 4


def test_screen_matches_the_reference_screen():
    fleets = {}
    for mod in (R, T):
        w = _regional(mod, 3)
        g = _catalog(mod)[1][1]
        for r, count in enumerate((2, 4, 3)):
            for i in range(count):
                w.admit(g, mod.Workload(16 + 8 * i, 4 + i, 0.3 * (r + 1)),
                        source_node=4 * r + i % 3, now=0.0)
            w.inners[r].profiler.base_state.background_util[:3] = 0.3 + 0.2 * r
        sh = w._sharded()
        states = [o.profiler.system_state() for o in w.inners]
        fleets[mod] = sh.screen(states, weights=w.inners[0].weights,
                                bw_floor=w.inners[0].bw_floor_frac)
    mine, ref = fleets[T], fleets[R]
    for name in ("lat", "max_util", "min_bw", "tot_node", "tot_w"):
        np.testing.assert_allclose(getattr(mine, name), getattr(ref, name),
                                   rtol=RTOL, atol=0, err_msg=name)


def test_sync_shapes_grows_shards_with_rows_in_place():
    w = _regional(T, 3)
    g = _catalog(T)[0][1]
    for i in range(9):
        w.admit(g, T.Workload(24, 6, 0.4), source_node=4 + i % 3, now=0.0)
    w.admit(_catalog(T)[1][1], T.Workload(24, 6, 0.4), source_node=8,
            now=0.0)
    sh = w._sharded()
    before = [(o._buffers.layout(), o._buffers.version, _rows(o._buffers))
              for o in w.inners]
    rows, segs = sh.sync_shapes()
    assert rows == max(o._buffers.n_rows for o in w.inners)
    for (layout, version, content), o in zip(before, w.inners):
        buf = o._buffers
        assert (buf.n_rows, buf.max_segs) == (rows, segs)
        grew = len(layout["row_sid"]) < rows or int(layout["max_segs"]) < segs
        assert (buf.version != version) == grew
        now = buf.layout()
        assert np.array_equal(now["row_sid"][:len(layout["row_sid"])],
                              layout["row_sid"])
        for sid, fields in _rows(buf).items():
            for f, v in fields.items():
                old = content[sid][f]
                assert np.array_equal(v[:old.shape[0]] if v.ndim else v, old)


# --------------------------------------------------------------------- #
# 1. one region: bit-identical to a bare FleetOrchestrator
# --------------------------------------------------------------------- #
def _drive_churn(mod, orch, *, cycles, seed):
    """tests/test_sharded_fleet.py::_drive_churn through either package."""
    rng = np.random.default_rng(seed)
    prices, decisions = [], []
    base = orch.profiler.base_state
    cat, qos = _catalog(mod), _qos(mod)
    for t in range(1, cycles + 1):
        base.background_util[:] = rng.uniform(0.15, 0.9, base.num_nodes)
        base.background_util[3] = 0.10
        if rng.random() < 0.6 and len(orch.sessions) < 12:
            arch, g = cat[int(rng.integers(len(cat)))]
            wl = mod.Workload(tokens_in=int(rng.integers(16, 64)),
                              tokens_out=int(rng.integers(4, 12)),
                              arrival_rate=float(rng.uniform(0.3, 1.5)))
            orch.admit(g, wl, source_node=int(rng.integers(0, 3)),
                       arch=arch, now=float(t),
                       qos=qos[int(rng.integers(len(qos)))])
        if rng.random() < 0.25 and orch.sessions:
            sids = sorted(orch.sessions)
            orch.depart(sids[int(rng.integers(len(sids)))])
        s, lat, rho = orch.price_fleet(None, now=float(t))
        prices.append((list(s), np.asarray(lat), np.asarray(rho)))
        decisions.append(_decision(orch.step(float(t))))
    return prices, decisions


def test_single_region_is_bit_identical_to_monolithic_and_the_reference():
    mono = _mono(T)
    shard = _regional(T, 1)
    ref = _regional(R, 1)
    assert shard.n_regions == 1 and shard.profiler is shard.inners[0].profiler
    p_mono, d_mono = _drive_churn(T, mono, cycles=24, seed=7)
    p_shard, d_shard = _drive_churn(T, shard, cycles=24, seed=7)
    p_ref, d_ref = _drive_churn(R, ref, cycles=24, seed=7)
    for (s1, l1, r1), (s2, l2, r2) in zip(p_mono, p_shard):
        assert s1 == s2
        assert np.array_equal(l1, l2) and np.array_equal(r1, r2)
    assert d_mono == d_shard
    ra, rb = _rows(mono._buffers), _rows(shard.inners[0]._buffers)
    assert sorted(ra) == sorted(rb)
    for sid in ra:
        for f in _ROW_FIELDS:
            assert np.array_equal(ra[sid][f], rb[sid][f]), (sid, f)
    assert shard.screen_cycles == 0 and shard._shstate is None
    _assert_same_log(p_shard, p_ref)
    _assert_same_log(d_shard, d_ref)
    assert sum(len(d[1]) for d in d_shard) > 0


def test_single_region_wrapper_shares_sid_sequence():
    for mod in (R, T):
        w = _regional(mod, 1)
        g = _catalog(mod)[0][1]
        sids = [w.admit(g, mod.Workload(32, 8, 0.5), source_node=i)
                for i in (0, 1)]
        assert sids == [0, 1]           # no region stride at S == 1


# --------------------------------------------------------------------- #
# 2. conservation under seed-paired churn at 3 regions
# --------------------------------------------------------------------- #
def _sharded_churn(mod, seed):
    """tests/test_sharded_fleet.py's conservation schedule, logged."""
    rng = np.random.default_rng(seed)
    w = _regional(mod, 3)
    g = _catalog(mod)[0][1]
    qos = _qos(mod)
    alive: set = set()
    log = []
    for t in range(1, 15):
        op = rng.random()
        if op < 0.55 or not alive:
            src = int(rng.integers(0, 12))
            if src % 4 == 3:            # cloud nodes don't take ingress
                src -= 1
            sid = w.admit(g, mod.Workload(tokens_in=24, tokens_out=6,
                                          arrival_rate=0.4),
                          source_node=src, now=float(t),
                          qos=qos[int(rng.integers(len(qos)))])
            alive.add(sid)
            log.append(("admit", sid))
        elif op < 0.8:
            sid = sorted(alive)[int(rng.integers(len(alive)))]
            w.depart(sid)
            alive.discard(sid)
            log.append(("depart", sid))
        else:
            log.append(_decision(w.step(float(t))))
        if mod is T:
            _assert_conserved(w, alive)
        log.append(sorted((sid, w.region_of_sid(sid)) for sid in alive))
    log.append((w.screen_cycles, w.shards_stepped, w.cross_migrations,
                w.cross_rejected))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_churn_conserves_sessions_like_the_reference(seed):
    _assert_same_log(_sharded_churn(T, seed), _sharded_churn(R, seed))


# --------------------------------------------------------------------- #
# 3. steady state: one pricing call per shard, one screen, pack-free
# --------------------------------------------------------------------- #
def _quiet_cycles(mod):
    w = _regional(mod, 3, cost_model=mod.CalibratedCostModel())
    w.forecaster = mod.CapacityForecaster(
        mod.ForecastConfig(horizon_steps=4, season_steps=8,
                           sample_interval_s=1.0),
        **({"device": "cpu"} if mod is T else {}))
    assert all(o.forecaster is not None for o in w.inners)
    g = _catalog(mod)[0][1]
    for r in (0, 1, 2):
        for i in range(2):
            w.admit(g, mod.Workload(tokens_in=24, tokens_out=6,
                                    arrival_rate=0.3),
                    source_node=4 * r + i, now=0.0, qos=mod.QOS_BATCH)
    log = [_decision(w.step(float(t))) for t in range(1, 4)]
    kernels = {id(o.kernel): o.kernel for o in w.inners}
    disp0 = sum(k.dispatches for k in kernels.values())
    screens0 = w._shstate.screen_dispatches
    packs0 = [dict(o._buffers.stats) for o in w.inners]
    rebuilds0 = [o.full_rebuilds for o in w.inners]
    cycles = 5
    for t in range(4, 4 + cycles):
        d = w.step(float(t))
        assert d.n_migrate == 0 and d.n_resplit == 0
        log.append(_decision(d))
    for r, o in enumerate(w.inners):
        st = o._buffers.stats
        assert st["pack_time_s"] == packs0[r]["pack_time_s"]
        assert st["row_writes"] == packs0[r]["row_writes"]
        assert st["rebuilds"] == packs0[r]["rebuilds"]
        assert o.full_rebuilds == rebuilds0[r]
    assert w._shstate.screen_dispatches - screens0 == cycles
    disp = sum(k.dispatches for k in kernels.values()) - disp0
    return w, log, disp, cycles


def test_quiet_cycles_cost_one_call_per_shard_and_one_screen():
    w, log, disp, cycles = _quiet_cycles(T)
    assert all(o.forecaster.device == torch.device("cpu") for o in w.inners)
    # forecast ON → every shard prices every cycle: exactly one fused call
    # per shard per cycle, nothing else
    assert disp == 3 * cycles
    _, ref_log, ref_disp, _ = _quiet_cycles(R)
    assert ref_disp == disp
    _assert_same_log(log, ref_log)


# --------------------------------------------------------------------- #
# the cross-region pass
# --------------------------------------------------------------------- #
def _drill(mod):
    """tests/test_sharded_fleet.py's cross-region drill, logged."""
    w = _regional(mod, 3)
    g = _catalog(mod)[0][1]
    alive = []
    for r in (0, 1, 2):
        for i in range(3):
            alive.append(w.admit(
                g, mod.Workload(tokens_in=48, tokens_out=8, arrival_rate=0.8),
                source_node=4 * r + i, now=0.0, qos=mod.QOS_INTERACTIVE))
    log = [alive, _decision(w.step(1.0))]
    before = {sid: w.region_of_sid(sid) for sid in alive}
    w.inners[1].profiler.base_state.background_util[:3] = 0.97
    for t in range(2, 30):
        log.append(_decision(w.step(float(t))))
        if mod is T:
            _assert_conserved(w, set(alive))
        if w.cross_migrations:
            break
    moved = {sid: w.region_of_sid(sid) for sid in alive
             if w.region_of_sid(sid) != before[sid]}
    log.append((t, w.cross_migrations, w.cross_rejected, moved))
    return w, moved, log


def test_cross_region_drill_moves_the_reference_sids():
    w, moved, log = _drill(T)
    assert w.cross_migrations > 0 and moved
    for sid, r in moved.items():
        assert sid in w.sessions and r != 1   # same sid, fled region 1
        assert (sid >> 24) == 1               # born in region 1's namespace
    _, ref_moved, ref_log = _drill(R)
    assert moved == ref_moved
    _assert_same_log(log, ref_log)


def _refused_move(mod):
    """The drill with every agent of regions 0 and 2 dropping each RPC after
    admission: each cross move the aggregator prices aborts in the target's
    rollout, and the session must be back in its source row, bit for bit.
    Returns, per priced move, (sid, source, target, committed, source
    buffers before, after) and the run's log."""
    w, log, moves = _regional(mod, 3), [], []
    g = _catalog(mod)[0][1]
    for r in (0, 1, 2):
        for i in range(3):
            w.admit(g, mod.Workload(48, 8, 0.8), source_node=4 * r + i,
                    now=0.0, qos=mod.QOS_INTERACTIVE)
    for r in (0, 2):
        b = w.inners[r].broadcast
        b.agents = [mod.FlakyAgent(a, seed=5, drop_p=1.0) for a in b.agents]
    try_move = w._try_cross_migrate

    def probe(sess, rs, rt, state_t, now):
        buf = w.inners[rs]._buffers
        before = (_rows(buf), _layout(buf))
        ok = try_move(sess, rs, rt, state_t, now)
        moves.append((sess.sid, rs, rt, ok, before,
                      (_rows(buf), _layout(buf))))
        return ok

    w._try_cross_migrate = probe
    w.step(1.0)
    w.inners[1].profiler.base_state.background_util[:3] = 0.97
    for t in range(2, 24):
        log.append(_decision(w.step(float(t))))
    drops = sum(a.faults["drop"] for r in (0, 2)
                for a in w.inners[r].broadcast.agents)
    log.append((w.cross_migrations, w.cross_rejected, drops,
                [m[:4] for m in moves],
                sorted((s, w.region_of_sid(s)) for s in w.sessions),
                [o._next_sid for o in w.inners]))
    return w, moves, drops, log


def test_refused_cross_move_leaves_the_source_row_bit_identical():
    w, moves, drops, log = _refused_move(T)
    assert moves and drops > 0 and w.cross_migrations == 0
    for sid, rs, rt, ok, (rows, layout), (rows2, layout2) in moves:
        assert not ok and rs == 1 and rt != 1
        for k in ("row_sid", "free", "max_segs"):
            assert np.array_equal(layout[k], layout2[k]), k
        assert sorted(rows) == sorted(rows2)
        for f in _ROW_FIELDS:
            assert np.array_equal(rows[sid][f], rows2[sid][f]), (sid, f)
    _, _, _, ref_log = _refused_move(R)
    _assert_same_log(log, ref_log)


# --------------------------------------------------------------------- #
# region-routed admission
# --------------------------------------------------------------------- #
def _routed_admission(mod):
    w = _regional(mod, 3)
    ctrl = mod.ShardedFleetAdmissionController(w, max_sessions=12,
                                               queue_cap=6)
    cat, qos = _catalog(mod), _qos(mod)
    rng = np.random.default_rng(11)
    log = []
    for tick in range(6):
        t = float(tick)
        for _ in range(3):
            arch, g = cat[int(rng.integers(len(cat)))]
            node = int(rng.integers(0, 12))
            if node % 4 == 3:
                node -= 1
            v = ctrl.request(mod.AdmissionRequest(
                g, mod.Workload(int(rng.integers(16, 64)),
                                int(rng.integers(4, 12)),
                                float(rng.uniform(0.5, 4.0))),
                source_node=node, arch=arch,
                qos=qos[int(rng.integers(len(qos)))], t_submit=t), now=t)
            log.append((v.kind.value, v.sid, v.reason,
                        float(v.predicted_latency_s)))
        log.append([(v.kind.value, v.sid, v.reason) for _, v in
                    ctrl.poll(t + 0.5)])
        log.append((ctrl.queued, dict(ctrl.counters),
                    sorted((s, w.region_of_sid(s)) for s in w.sessions)))
    # a departure in region 2 frees a slot for its queued tenants
    w.depart(min(sid for sid in w.sessions if sid >> 24 == 2))
    log.append([(v.kind.value, v.sid, v.reason, float(v.predicted_latency_s))
                for _, v in ctrl.poll(6.5)])
    # region 1's node 1 dies: its weights no longer fit; a global state is
    # sliced per region for the revocation pass
    state = w.profiler.system_state()
    state.mem_bytes[5] = 0.0
    state.background_util[5] = 0.99
    log.append(sorted(s.sid for s, _ in ctrl.preempt_overload(7.0,
                                                              state=state)))
    ctrl.preempt_patience_s = 30.0
    log.append((ctrl.preempt_patience_s, ctrl.queued, ctrl.kpis(),
                dict(ctrl.preempted_by_class)))
    return ctrl, log


def test_sharded_admission_controller_matches_reference():
    ctrl, log = _routed_admission(T)
    kinds = {x[0] for x in log if isinstance(x, tuple) and len(x) == 4
             and isinstance(x[0], str)}
    assert kinds == {"accept", "defer", "reject"}
    assert ctrl.counters["accepted_from_queue"] > 0
    assert ctrl.counters["preempted"] > 0
    assert all(c.max_sessions == 4 and c.queue_cap == 2
               for c in ctrl.regional)
    _, ref_log = _routed_admission(R)
    _assert_same_log(log, ref_log)


def test_region_routing_refuses_a_global_heartbeat_registry():
    for mod, hb in ((R, RHeartbeats), (T, THeartbeats)):
        w = _regional(mod, 2)
        with pytest.raises(ValueError):
            w.heartbeats = hb(nodes=list(range(8)))
        w.heartbeats = None
        assert w.locate_node(6) == (1, 2)
        with pytest.raises(KeyError):
            w.region_of_sid(123)


def test_port_sharded_orchestrator_is_exported_where_the_reference_is():
    for name in ("ShardScreen", "ShardedFleetAdmissionController",
                 "ShardedFleetOrchestrator", "ShardedFleetState",
                 "region_slice"):
        assert name in R.__all__ and name in T.__all__, name
    for name in ("build_regional_orchestrator", "regional_system_state",
                 "Trace", "constant", "diurnal", "ou_process", "square_wave"):
        assert name in RE.__all__ and name in TE.__all__, name
    assert RF._REGION_SID_BASE == T.fleet._REGION_SID_BASE == 1 << 24
