"""The port's batched fleet programs against the reference, on the CPU.

Seeded numpy inputs go through the reference (``repro.core.fleet_eval``,
its jitted float64 programs run under ``enable_x64``) and the port
(``repro_torch.core.fleet_eval`` with ``device="cpu"``).  Integer outputs
(assignments, sweep counts, masks) must be identical; float outputs agree to
1e-12 relative.  The port is also held against its own scalar oracles:
``CostModel.evaluate``, ``solve_placement_chain_dp``, ``repair_capacity``
and ``fixed_point_reference``.
"""

import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import fleet_eval as jfe
from repro_torch.core import fleet_eval as tfe

RTOL = 1e-12
N = 4


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
def _ref(cls):
    """One shared instance of a reference component, so its jitted programs
    compile once per shape for the whole file."""
    return cls()


# --------------------------------------------------------------------- #
# seeded instances, built in either package from one RNG stream
# --------------------------------------------------------------------- #
def _state(mod, seed, n=N):
    rng = np.random.default_rng(seed)
    bw = rng.uniform(1e6, 1e8, (n, n))
    bw = (bw + bw.T) / 2
    np.fill_diagonal(bw, np.inf)
    trusted = rng.random(n) < 0.6
    trusted[0] = True
    return mod.SystemState(
        flops_per_s=rng.uniform(1e12, 1e14, n),
        mem_bytes=rng.uniform(5e8, 5e9, n),
        background_util=rng.uniform(0.0, 0.8, n),
        trusted=trusted,
        link_bw=bw,
        link_lat=np.full((n, n), 4e-3) * (1 - np.eye(n)),
        mem_bw=rng.uniform(1e11, 2e12, n),
    )


def _items(mod, seed, n_sessions, *, wscale=5e8, stack=False, n=N):
    """(graph, boundaries, assignment, workload, source, ibt) per session;
    ``stack=True`` piles every segment onto one node (overfull rows)."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n_sessions):
        L = int(rng.integers(3, 9))
        g = mod.ModelGraph("g", [
            mod.GraphNode(f"u{i}", float(rng.uniform(1e8, 2e9)),
                          float(rng.uniform(0.2, 1.0) * wscale),
                          float(rng.uniform(1e3, 2e4)),
                          privacy_critical=bool(rng.random() < 0.2))
            for i in range(L)
        ])
        wl = mod.Workload(tokens_in=int(rng.integers(8, 128)),
                          tokens_out=int(rng.integers(1, 32)),
                          arrival_rate=float(rng.uniform(0.1, 4.0)))
        k = int(rng.integers(1, min(4, L) + 1))
        cuts = sorted(rng.choice(np.arange(1, L), size=k - 1,
                                 replace=False).tolist())
        b = tuple([0] + cuts + [L])
        if stack:
            a = tuple([int(rng.integers(0, n))] * (len(b) - 1))
        else:
            a = tuple(int(x) for x in rng.integers(0, n, len(b) - 1))
        items.append((g, b, a, wl, int(rng.integers(0, n)), 4.0))
    return items


def _per_row(seed, state, B, *, tight=False):
    """Per-row effective (bg, link_bw, mem) around ``state``."""
    rng = np.random.default_rng(seed + 99)
    bg = np.clip(state.background_util[None]
                 + rng.uniform(0, 0.15, (B, N)), 0, 0.99)
    lbw = state.link_bw[None] * rng.uniform(0.4, 1.0, (B, N, N))
    for i in range(B):
        np.fill_diagonal(lbw[i], np.inf)
    mem = state.mem_bytes[None] * rng.uniform(0.1 if tight else 0.5,
                                              0.6 if tight else 3.0, (B, N))
    if tight:
        mem[:, 0] = 1e12      # a roomy trusted node keeps every row feasible
    return bg, lbw, mem


def _row_state(state, bg, lbw, mem):
    st = state.copy()
    st.background_util, st.link_bw, st.mem_bytes = (
        bg.copy(), lbw.copy(), mem.copy())
    return st


def _eq_packed(a, b):
    for name in ("seg_flops", "seg_wbytes", "seg_priv", "seg_node", "valid",
                 "xfer_bytes_tok", "n_segs", "t_in", "t_out", "lam", "source",
                 "input_bytes_tok"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.boundaries == b.boundaries


# --------------------------------------------------------------------- #
# packing, evaluator, migration DP, repair
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_pack_sessions_and_induced_loads_bit_for_bit(seed):
    pr = R.pack_sessions(_items(R, seed, 7))
    pt = T.pack_sessions(_items(T, seed, 7), min_k=8)
    _eq_packed(R.pack_sessions(_items(R, seed, 7), min_k=8), pt)
    _eq_packed(pr, T.pack_sessions(_items(T, seed, 7)))
    for a, b in zip(R.packed_induced_loads(pr, _state(R, seed)),
                    T.packed_induced_loads(T.pack_sessions(_items(T, seed, 7)),
                                           _state(T, seed))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_evaluator_matches_reference_and_scalar_cost_model(seed):
    items_t = _items(T, seed, 6)
    state_t, state_r = _state(T, seed), _state(R, seed)
    packed = T.pack_sessions(items_t)
    bg, lbw, mem = _per_row(seed, state_t, packed.batch)
    w = T.CostWeights(alpha=1.0, beta=0.02, gamma=1000.0)
    lat, tot, rho = T.FleetCostEvaluator(device="cpu").evaluate_batch(
        packed, bg=bg, link_bw=lbw, mem_bytes=mem, state=state_t, weights=w)
    r_lat, r_tot, r_rho = _ref(R.FleetCostEvaluator).evaluate_batch(
        R.pack_sessions(_items(R, seed, 6)), bg=bg, link_bw=lbw,
        mem_bytes=mem, state=state_r,
        weights=R.CostWeights(alpha=1.0, beta=0.02, gamma=1000.0))
    np.testing.assert_allclose(lat, r_lat, rtol=RTOL, atol=0)
    np.testing.assert_allclose(tot, r_tot, rtol=RTOL, atol=0)
    np.testing.assert_allclose(rho, r_rho, rtol=RTOL, atol=0)
    cm = T.AnalyticCostModel()
    for i, (g, b, a, wl, _, _) in enumerate(items_t):
        st = _row_state(state_t, bg[i], lbw[i], mem[i])
        assert lat[i] == pytest.approx(cm.chain_latency(g, b, a, st, wl),
                                       rel=RTOL)
        assert tot[i] == pytest.approx(cm.evaluate(g, b, a, st, wl, w),
                                       rel=RTOL)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("use_mem", [False, True])
def test_migration_solver_matches_reference_and_chain_dp(seed, use_mem):
    items_t = _items(T, seed, 5, wscale=2e9)
    state_t = _state(T, seed + 1)
    packed = T.pack_sessions(items_t)
    bg, lbw, mem = _per_row(seed, state_t, packed.batch, tight=True)
    sols = T.BatchedMigrationSolver(device="cpu").solve_batch(
        packed, bg=bg, link_bw=lbw, state=state_t,
        mem=mem if use_mem else None)
    ref = _ref(R.BatchedMigrationSolver).solve_batch(
        R.pack_sessions(_items(R, seed, 5, wscale=2e9)), bg=bg, link_bw=lbw,
        state=_state(R, seed + 1), mem=mem if use_mem else None)
    for i, (g, b, _, wl, src, _) in enumerate(items_t):
        assert (sols[i].boundaries, sols[i].assignment) == \
            (ref[i].boundaries, ref[i].assignment)
        assert sols[i].cost == pytest.approx(ref[i].cost, rel=RTOL)
        st = _row_state(state_t, bg[i], lbw[i], state_t.mem_bytes)
        dp = T.solve_placement_chain_dp(
            g, b, st, wl, source_node=src,
            mem_residual=mem[i] if use_mem else None)
        assert sols[i].assignment == dp.assignment
        if dp.cost < 1e29:
            assert sols[i].cost == pytest.approx(dp.cost, rel=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_repair_pass_matches_reference_and_scalar_repair(seed):
    items_t = _items(T, seed, 6, wscale=2e9, stack=bool(seed % 2))
    state_t = _state(T, seed + 2)
    packed = T.pack_sessions(items_t)
    B = packed.batch
    bg, lbw, mem = _per_row(seed, state_t, B)
    lbw = np.repeat(state_t.link_bw[None], B, axis=0)
    rep = T.BatchedRepairPass(device="cpu")
    mine = rep.repair_batch(packed, bg=bg, link_bw=lbw, mem=mem, state=state_t)
    packed_r = R.pack_sessions(_items(R, seed, 6, wscale=2e9,
                                      stack=bool(seed % 2)))
    ref = _ref(R.BatchedRepairPass).repair_batch(
        packed_r, bg=bg, link_bw=lbw, mem=mem, state=_state(R, seed + 2))
    np.testing.assert_array_equal(mine, ref)
    a2, lat2 = rep.repair_and_price_batch(packed, bg=bg, link_bw=lbw, mem=mem,
                                          state=state_t)
    ra2, rlat2 = _ref(R.BatchedRepairPass).repair_and_price_batch(
        packed_r, bg=bg, link_bw=lbw, mem=mem, state=_state(R, seed + 2))
    np.testing.assert_array_equal(a2, ra2)
    np.testing.assert_allclose(lat2, rlat2, rtol=RTOL, atol=0)
    over_after = T.memory_violations_packed(packed.seg_wbytes, mine,
                                            packed.valid, mem)
    for i, (g, b, a, wl, _, _) in enumerate(items_t):
        st = _row_state(state_t, bg[i], state_t.link_bw, mem[i])
        if not T.memory_violations(g, b, a, st).any():
            assert tuple(int(x) for x in mine[i, :len(a)]) == a
            continue
        scalar = T.repair_capacity(g, T.Solution(b, a, 0.0), st, wl)
        if not T.memory_violations(g, scalar.boundaries, scalar.assignment,
                                   st).any():
            assert not over_after[i].any()


@pytest.mark.parametrize("seed", range(3))
def test_device_surrogate_matches_host_reference(seed):
    items_t = _items(T, seed, 5)
    state = _state(T, seed)
    packed = T.pack_sessions(items_t)
    bg, lbw, mem = _per_row(seed, state, packed.batch)
    host = tfe._surrogate_inputs(packed, bg=bg, link_bw=lbw, state=state,
                                 mem=mem)
    t = functools.partial(torch.as_tensor)
    dev = tfe._surrogate_batch(
        t(packed.seg_flops), t(packed.seg_wbytes), t(packed.seg_priv),
        t(packed.xfer_bytes_tok), t(packed.t_in), t(packed.t_out),
        t(packed.lam), t(packed.source), t(packed.input_bytes_tok), t(bg),
        t(np.nan_to_num(lbw, posinf=tfe._BIG)),
        t(np.nan_to_num(state.link_lat, posinf=tfe._BIG)),
        t(state.flops_per_s), t(state.mem_bw), t(state.trusted.astype(bool)),
        t(mem))
    for h, d in zip(host, dev):
        np.testing.assert_allclose(d.numpy(), h, rtol=RTOL, atol=0)


# --------------------------------------------------------------------- #
# the red/black fixed point: device program vs reference vs oracles
# --------------------------------------------------------------------- #
def _fp_instance(seed, B=8, K=4, n=4, tight=False):
    rng = np.random.default_rng(seed)
    n_segs = rng.integers(1, K + 1, size=B)
    valid = np.arange(K)[None, :] < n_segs[:, None]
    seg_flops = rng.uniform(1e9, 8e10, (B, K)) * valid
    seg_w = rng.uniform(2e8, 2e9, (B, K)) * valid
    seg_priv = (rng.random((B, K)) < 0.15) & valid
    seg_node0 = rng.integers(0, n, (B, K)) * valid
    xbytes = rng.uniform(1e4, 5e5, (B, K)) * valid
    active = rng.random(B) < 0.9
    active[0] = True
    trig = (rng.random(B) < 0.7) & active
    force = (rng.random(B) < 0.15) & trig
    slo = rng.uniform(0.05, 0.4, B)
    bg = rng.uniform(0.05, 0.45, n)
    bw = rng.uniform(5e7, 5e8, (n, n))
    bw = (bw + bw.T) / 2
    np.fill_diagonal(bw, tfe._BIG)
    trusted = rng.random(n) < 0.8
    trusted[0] = True
    per_node = seg_w[valid].sum() / n
    mem = rng.uniform(1.2 if tight else 2.5, 1.8 if tight else 4.0, n)
    return dict(
        seg_flops=seg_flops, seg_w=seg_w, seg_priv=seg_priv,
        seg_node0=seg_node0.astype(np.int64), valid=valid, xbytes=xbytes,
        n_segs=n_segs.astype(np.int64),
        t_in=rng.uniform(16, 64, B), t_out=rng.uniform(4, 16, B),
        lam=rng.uniform(0.5, 4.0, B),
        source=rng.integers(0, n, B).astype(np.int64),
        input_bytes_tok=np.full(B, 4.0),
        active=active, trig=trig, force=force, slo=slo,
        base_bg=bg, base_lbw=bw * 0.9, link_bw=bw, link_lat=np.full(
            (n, n), 2e-3) * (1 - np.eye(n)),
        flops_per_s=rng.uniform(5e12, 3e13, n),
        mem_bw=np.full(n, 1e12), trusted=trusted, mem_bytes=mem * per_node,
    )


_FP_ORDER = [
    "seg_flops", "seg_w", "seg_priv", "seg_node0", "valid", "xbytes",
    "n_segs", "t_in", "t_out", "lam", "source", "input_bytes_tok",
    "active", "trig", "force", "slo", "base_bg", "base_lbw", "link_bw",
    "link_lat", "flops_per_s", "mem_bw", "trusted", "mem_bytes",
]
_FP_KW = dict(mem_penalty=1e3, bw_floor=0.05, imp_frac=0.10, max_sweeps=8)


@functools.lru_cache(maxsize=None)
def _jax_fixed_point(K, n):
    return jax.jit(jfe._make_fixed_point(K, n, 1.0, 0.05, 1000.0, 1e3, 0.05,
                                         0.10, 8))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tight", [False, True])
def test_fixed_point_matches_reference_program_and_oracles(seed, tight):
    inst = _fp_instance(seed, tight=tight)
    import jax.numpy as jnp
    with jax.experimental.enable_x64(True):
        ref = [np.asarray(o) for o in _jax_fixed_point(4, 4)(
            *[jnp.asarray(inst[k]) for k in _FP_ORDER])]
    mine = tfe._fixed_point(
        *[torch.as_tensor(inst[k]) for k in _FP_ORDER],
        weights=T.CostWeights(1.0, 0.05, 1000.0), **_FP_KW)
    mine = [m if isinstance(m, int) else m.numpy() for m in mine]
    a, lat, sweeps, moved, moved_pre, abort = mine[:6]
    np.testing.assert_array_equal(a, ref[0])
    assert sweeps == int(ref[2])
    np.testing.assert_array_equal(moved, ref[3])
    np.testing.assert_array_equal(moved_pre, ref[4])
    assert bool(abort) == bool(ref[5])
    np.testing.assert_allclose(lat, ref[1], rtol=RTOL, atol=0)
    for m, r in zip(mine[6:], ref[6:]):          # bg, lbw, mem, totals
        np.testing.assert_allclose(m, r, rtol=RTOL, atol=1e-300)
    kw = dict(alpha=1.0, beta=0.05, gamma=1000.0, mem_penalty=1e3,
              bw_floor=0.05, imp_frac=0.10, max_sweeps=8)
    for oracle in (T.fixed_point_reference, R.fixed_point_reference):
        o = oracle(*[inst[k] for k in _FP_ORDER], **kw)
        np.testing.assert_array_equal(a, o[0])
        assert sweeps == o[2] and bool(abort) == o[5]
        np.testing.assert_array_equal(moved, o[3])
        np.testing.assert_array_equal(moved_pre, o[4])
        live = inst["active"]
        np.testing.assert_allclose(lat[live], o[1][live], rtol=1e-9)


# --------------------------------------------------------------------- #
# resident buffers and the fused programs over them
# --------------------------------------------------------------------- #
def _buffer_ops(mod, seed, **dev):
    """An admit / depart / commit sequence against one buffer."""
    items = _items(mod, seed, 10)
    buf = mod.FleetStateBuffers(rows=2, segs=1, **dev)
    for sid, it in enumerate(items[:6]):
        buf.upsert(sid, *it)
    buf.remove(2)
    buf.remove(4)
    for sid, it in zip((6, 7, 8), items[6:9]):
        buf.upsert(sid, *it)
    g, b, a, wl, src, ibt = items[9]
    buf.upsert(1, g, b, tuple((x + 1) % N for x in a), wl, src, ibt)  # commit
    live = {0: items[0], 1: (g, b, tuple((x + 1) % N for x in a), wl, src,
                             ibt),
            3: items[3], 5: items[5], 6: items[6], 7: items[7], 8: items[8]}
    return buf, live


_FIELDS = ("seg_flops", "seg_wbytes", "seg_priv", "seg_node", "valid",
           "xfer_bytes_tok", "n_segs", "t_in", "t_out", "lam", "source",
           "input_bytes_tok", "active")


@pytest.mark.parametrize("seed", range(3))
def test_resident_rows_match_reference_and_cold_repack(seed):
    mine, live = _buffer_ops(T, seed, device="cpu")
    ref, _ = _buffer_ops(R, seed)
    assert mine.row_of == ref.row_of and mine._free == ref._free
    assert (mine.n_rows, mine.max_segs) == (ref.n_rows, ref.max_segs)
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    free = [r for r in range(mine.n_rows) if r not in mine.row_of.values()]
    for name in _FIELDS:
        assert not getattr(mine, name)[free].any()     # inactive rows: zeros
    sids = sorted(live)
    cold = T.FleetStateBuffers.from_sessions(
        [(s, live[s]) for s in sids], min_segs=mine.max_segs, device="cpu")
    _eq_packed(mine.rows_packed(sids), cold.rows_packed(sids))
    _eq_packed(mine.rows_packed(sids),
               T.pack_sessions([live[s] for s in sids], min_k=mine.max_segs))


def _price_fields(p):
    return [p.lat, p.max_util, p.min_bw, p.bg, p.link_bw, p.mem, p.tot_node,
            p.tot_link, p.tot_w]


@pytest.mark.parametrize("seed", range(3))
def test_price_and_migrate_match_reference(seed):
    mine, _ = _buffer_ops(T, seed, device="cpu")
    ref, _ = _buffer_ops(R, seed)
    state_t, state_r = _state(T, seed + 5), _state(R, seed + 5)
    kt = T.ResidentFleetKernel(device="cpu")
    kr = _ref(R.ResidentFleetKernel)
    w_t = T.CostWeights(alpha=1.0, beta=0.02, gamma=1000.0)
    w_r = R.CostWeights(alpha=1.0, beta=0.02, gamma=1000.0)
    pt = kt.price(mine, state_t, weights=w_t)
    pr = kr.price(ref, state_r, weights=w_r)
    for m, r in zip(_price_fields(pt), _price_fields(pr)):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-300)
    at, lt, ct = kt.migrate(mine, pt, state_t, weights=w_t)
    ar, lr, cr = kr.migrate(ref, pr, state_r, weights=w_r)
    np.testing.assert_array_equal(at.numpy(), np.asarray(ar))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=RTOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cr), rtol=RTOL)
    B = mine.n_rows
    rng = np.random.default_rng(seed)
    trig = rng.random(B) < 0.7
    force = rng.random(B) < 0.1
    slo = rng.uniform(0.05, 0.5, B)
    base_bg = np.clip(state_t.background_util + 0.1, 0, 0.99)
    for base in (None, base_bg):
        ft = kt.migrate_fixed_point(mine, state_t, trig=trig, force=force,
                                    slo=slo, weights=w_t, base_bg=base)
        fr = kr.migrate_fixed_point(ref, state_r, trig=trig, force=force,
                                    slo=slo, weights=w_r, base_bg=base)
        np.testing.assert_array_equal(ft.assign.numpy(),
                                      np.asarray(fr.assign))
        assert ft.sweeps == int(fr.sweeps)
        assert bool(ft.aborted) == bool(fr.aborted)
        np.testing.assert_array_equal(ft.moved.numpy(), np.asarray(fr.moved))
        np.testing.assert_allclose(ft.lat.numpy(), np.asarray(fr.lat),
                                   rtol=RTOL)
        np.testing.assert_allclose(ft.tot_link.numpy(),
                                   np.asarray(fr.tot_link), rtol=RTOL)


@pytest.mark.parametrize("horizon", [0, 2])
def test_price_with_forecaster_matches_reference(horizon):
    mine, _ = _buffer_ops(T, 7, device="cpu")
    ref, _ = _buffer_ops(R, 7)
    kt, kr = T.ResidentFleetKernel(device="cpu"), _ref(R.ResidentFleetKernel)
    ft = T.CapacityForecaster(T.ForecastConfig(horizon_steps=horizon,
                                               season_steps=3), device="cpu")
    fr = R.CapacityForecaster(R.ForecastConfig(horizon_steps=horizon,
                                               season_steps=3))
    rng = np.random.default_rng(7)
    for c, now in enumerate([0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.0]):
        st_t, st_r = _state(T, 3), _state(R, 3)
        bump = rng.uniform(0, 0.2, N)
        st_t.background_util = np.clip(st_t.background_util + bump, 0, 0.99)
        st_r.background_util = st_t.background_util.copy()
        pt = kt.price(mine, st_t, forecaster=ft, now=now)
        pr = kr.price(ref, st_r, forecaster=fr, now=now)
        assert pt.has_forecast and pr.has_forecast
        for m, r in zip(
                _price_fields(pt) + [pt.lat_fc, pt.max_util_fc, pt.min_bw_fc,
                                     pt.bg_fc, pt.lbw_fc],
                _price_fields(pr) + [pr.lat_fc, pr.max_util_fc, pr.min_bw_fc,
                                     pr.bg_fc, pr.lbw_fc]):
            np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=1e-300)
        assert (ft.idx, ft.count, ft.ready) == (fr.idx, fr.count, fr.ready)
        np.testing.assert_allclose(ft.bg_wc, fr.bg_wc, rtol=RTOL)
        np.testing.assert_allclose(ft.bw_wc, fr.bw_wc, rtol=RTOL)
    at, _, _ = kt.migrate(mine, pt, st_t, use_forecast=True)
    ar, _, _ = kr.migrate(ref, pr, st_r, use_forecast=True)
    np.testing.assert_array_equal(at.numpy(), np.asarray(ar))


def test_to_host_keeps_shapes_and_dtypes():
    a = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    b = torch.tensor([True, False])
    c = torch.tensor([[1.5, -2.0]], dtype=torch.float64)
    ha, hb, hc = tfe.to_host(a, b, c)
    assert ha.dtype == np.int64 and ha.shape == (2, 3)
    assert hb.dtype == bool and hb.tolist() == [True, False]
    np.testing.assert_array_equal(hc, c.numpy())


def test_components_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for make in (T.FleetCostEvaluator, T.BatchedMigrationSolver,
                 T.BatchedRepairPass, T.ResidentFleetKernel,
                 T.FleetStateBuffers):
        with pytest.raises(RuntimeError):
            make()
