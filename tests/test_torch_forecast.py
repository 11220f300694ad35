"""The port's capacity forecaster against the reference, on the CPU.

The three ring helpers run on seeded inputs through both packages, and a
``CapacityForecaster.observe`` sequence (with a NaN sample, sample-interval
gating, a missed-sample gap and ``horizon_steps = 0``) is replayed through
both forecasters.  Floats agree to 1e-12 relative; ring positions, counts
and readiness are identical.
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CapacityForecaster as JaxForecaster
from repro.core import ForecastConfig as JaxConfig
from repro.core import forecast as jax_fc
from repro_torch.core import (CapacityForecaster, ForecastConfig,
                              seasonal_forecast, seasonal_update,
                              worst_case_capacity)

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


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _ring_inputs(seed, S=6, n=4, nan=False):
    rng = np.random.default_rng(seed)
    ring = rng.uniform(0.0, 0.9, (S, n))
    resid = rng.normal(0.0, 0.05, n)
    y = rng.uniform(0.0, 0.9, n)
    if nan:
        y[1] = np.nan
    bw_ring = rng.uniform(1e6, 1e8, (S, n, n))
    resid_b = rng.normal(0.0, 1e5, (n, n))
    y_b = rng.uniform(1e6, 1e8, (n, n))
    return ring, resid, y, bw_ring, resid_b, y_b


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("count", [2, 6, 9])
@pytest.mark.parametrize("advance", [True, False])
@pytest.mark.parametrize("nan", [False, True])
def test_seasonal_update_matches_reference(seed, count, advance, nan):
    ring, resid, y, *_ = _ring_inputs(seed, nan=nan)
    idx = seed % ring.shape[0]
    with jax.experimental.enable_x64(True):
        r_ring, r_resid = jax_fc.seasonal_update(
            jnp.asarray(ring), jnp.asarray(resid), jnp.asarray(idx),
            jnp.asarray(count), jnp.asarray(y), jnp.asarray(advance), 0.2)
        r_ring, r_resid = np.asarray(r_ring), np.asarray(r_resid)
    p_ring, p_resid = seasonal_update(_t(ring), _t(resid), idx, count,
                                      _t(y), advance, 0.2)
    np.testing.assert_allclose(p_ring.numpy(), r_ring, rtol=RTOL, atol=0)
    np.testing.assert_allclose(p_resid.numpy(), r_resid, rtol=RTOL, atol=0)
    assert np.isfinite(p_ring.numpy()).all()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("horizon", [0, 1, 4, 6])
@pytest.mark.parametrize("count", [3, 6, 11])
def test_forecast_and_worst_case_match_reference(seed, horizon, count):
    ring, resid, y, bw_ring, resid_b, y_b = _ring_inputs(seed)
    idx = (seed + 2) % ring.shape[0]
    with jax.experimental.enable_x64(True):
        args = [jnp.asarray(a) for a in (ring, resid, bw_ring, resid_b)]
        r_bg, r_bw = jax_fc.worst_case_capacity(
            *args, jnp.asarray(idx), jnp.asarray(count), jnp.asarray(y),
            jnp.asarray(y_b), horizon)
        r_bg, r_bw = np.asarray(r_bg), np.asarray(r_bw)
        if horizon:
            r_fc = np.asarray(jax_fc.seasonal_forecast(
                args[0], args[1], jnp.asarray(idx), horizon))
    p_bg, p_bw = worst_case_capacity(
        _t(ring), _t(resid), _t(bw_ring), _t(resid_b), idx, count, _t(y),
        _t(y_b), horizon)
    np.testing.assert_allclose(p_bg.numpy(), r_bg, rtol=RTOL, atol=0)
    np.testing.assert_allclose(p_bw.numpy(), r_bw, rtol=RTOL, atol=0)
    if horizon:
        p_fc = seasonal_forecast(_t(ring), _t(resid), idx, horizon)
        np.testing.assert_allclose(p_fc.numpy(), r_fc, rtol=RTOL, atol=0)


def _samples(seed, n=4, steps=30):
    """A noisy square wave on node 0, OU-ish links, one NaN util sample, one
    NaN link sample and an infinite (local) diagonal."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        bg = np.full(n, 0.15) + rng.normal(0, 0.02, n)
        bg[0] = (0.9 if t % 8 < 2 else 0.2) + rng.normal(0, 0.02)
        bw = rng.uniform(5e6, 5e7, (n, n))
        np.fill_diagonal(bw, np.inf)
        if t == 11:
            bg[2] = np.nan
        if t == 17:
            bw[1, 3] = np.nan
        out.append((bg, bw))
    return out


# (sample times): a steady 1 s cadence, then a read-only repeat, then a gap
_TIMES = [float(t) for t in range(20)] + [19.5, 23.0] + [
    float(t) for t in range(24, 32)]


@pytest.mark.parametrize("horizon,season", [(4, 8), (8, 8), (0, 8), (3, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_observe_sequence_matches_reference(horizon, season, seed):
    cfg = dict(horizon_steps=horizon, season_steps=season,
               sample_interval_s=1.0, residual_alpha=0.2)
    ref = JaxForecaster(JaxConfig(**cfg))
    mine = CapacityForecaster(ForecastConfig(**cfg), device="cpu")
    for now, (bg, bw) in zip(_TIMES, _samples(seed, steps=len(_TIMES))):
        adv_r = ref.observe(now, bg, bw)
        adv_m = mine.observe(now, bg, bw)
        assert adv_m == adv_r
        assert (mine.idx, mine.count, mine.ready, mine.bad_samples) == \
            (ref.idx, ref.count, ref.ready, ref.bad_samples)
        assert mine._last_t == ref._last_t
        np.testing.assert_allclose(mine.bg_wc, ref.bg_wc, rtol=RTOL, atol=0)
        np.testing.assert_allclose(mine.bw_wc, ref.bw_wc, rtol=RTOL, atol=0)
        # a poisoned sample never enters the rings (skip-and-hold)
        assert np.isfinite(mine.util_ring.numpy()).all()
        assert not np.isnan(mine.bw_ring.numpy()).any()
        for name in ("util_ring", "bw_ring", "resid_util", "resid_bw"):
            np.testing.assert_allclose(
                getattr(mine, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=RTOL, atol=0)
        if mine.enabled:
            np.testing.assert_allclose(mine.predict_util(),
                                       ref.predict_util(), rtol=RTOL, atol=0)
    if horizon == 0:
        # the contractual off-switch: worst case == the current sample
        bg, bw = _samples(seed, steps=len(_TIMES))[-1]
        np.testing.assert_array_equal(mine.bg_wc, bg)


def test_state_dict_round_trip(tmp_path):
    cfg = ForecastConfig(horizon_steps=4, season_steps=6)
    a = CapacityForecaster(cfg, device="cpu")
    assert a.state_dict() == {}
    for t, (bg, bw) in enumerate(_samples(3, steps=9)):
        a.observe(float(t), bg, bw)
    a.save(tmp_path / "fc.npz")
    b = CapacityForecaster(cfg, device="cpu")
    assert b.load(tmp_path / "fc.npz")
    assert (b.idx, b.count, b.ready, b._last_t) == \
        (a.idx, a.count, a.ready, a._last_t)
    np.testing.assert_array_equal(b.predict_util(), a.predict_util())
    with pytest.raises(ValueError):
        CapacityForecaster(ForecastConfig(horizon_steps=4, season_steps=7),
                           device="cpu").load_state_dict(a.state_dict())


def test_forecaster_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError):
        CapacityForecaster(ForecastConfig())
