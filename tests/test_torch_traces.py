"""The port's seeded time-series generators against the reference.

Every ``Trace`` factory of ``edgesim/traces.py`` — ``constant``,
``square_wave``, ``ou_process``, ``diurnal`` and ``compose`` — is sampled on
a grid of times with the same arguments and seeds in both packages, and
every sample is identical bit for bit.
"""

import numpy as np
import pytest

import repro.edgesim.traces as RT
import repro_torch.edgesim.traces as TT

# a grid across the pre-sampled horizon: tick boundaries, fractions of a
# tick, past the horizon (the last sample holds), and negative times
TIMES = np.concatenate([np.linspace(-1.0, 130.0, 997), [0.0, 0.1, 0.2,
                                                        59.95, 1e4]])


def _samples(tr):
    return np.array([tr(float(t)) for t in TIMES])


def _assert_same(build, *args, **kw):
    a, b = _samples(build(TT, *args, **kw)), _samples(build(RT, *args, **kw))
    assert np.array_equal(a, b)
    return a


@pytest.mark.parametrize("v", [0.0, 0.37, 2.5])
def test_constant_matches_reference(v):
    assert (_assert_same(lambda m: m.constant(v)) == v).all()


@pytest.mark.parametrize("base,high,period,duty,phase", [
    (0.3, 0.7, 40.0, 0.25, 0.0), (0.1, 0.95, 7.5, 0.6, 3.2),
    (0.5, 0.2, 1.0, 0.0, 0.0)])
def test_square_wave_matches_reference(base, high, period, duty, phase):
    x = _assert_same(lambda m: m.square_wave(base, high, period, duty,
                                             phase_s=phase))
    assert set(np.unique(x)) <= {base, high}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("mu,sigma,theta", [(0.3, 0.1, 0.5),
                                            (0.8, 0.4, 2.0)])
def test_ou_process_matches_reference(seed, mu, sigma, theta):
    x = _assert_same(lambda m: m.ou_process(seed, mu, sigma, theta=theta,
                                            horizon_s=120.0))
    assert ((x >= 0.0) & (x <= 1.0)).all()


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("kw", [
    dict(base=0.45, amp=0.15, period_s=24.0, spike_rate_per_period=1.0,
         spike_amp=0.15, spike_width_s=2.0, horizon_s=120.0),
    dict(base=0.3, amp=0.2, phase_s=10.0, tick_s=0.25, horizon_s=600.0),
])
def test_diurnal_matches_reference(seed, kw):
    x = _assert_same(lambda m: m.diurnal(seed, **kw))
    assert ((x >= 0.0) & (x <= 0.99)).all()


@pytest.mark.parametrize("op", ["add", "max", "mul"])
def test_compose_matches_reference(op):
    def build(m):
        return m.compose(m.square_wave(0.2, 0.6, 10.0, 0.3),
                         m.ou_process(3, 0.2, 0.2, horizon_s=140.0),
                         m.diurnal(2, 0.3, 0.1, period_s=30.0,
                                   horizon_s=140.0),
                         op=op, hi=0.99)
    _assert_same(build)


def test_compose_refuses_unknown_op_like_the_reference():
    for m in (RT, TT):
        with pytest.raises(ValueError):
            m.compose(m.constant(0.1), op="min")(0.0)
