"""Seeded time-series generators for the edge environment (util, bandwidth)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["Trace", "constant", "square_wave", "ou_process", "diurnal",
           "compose"]


@dataclass(frozen=True)
class Trace:
    """A deterministic function of time, pre-sampled on a tick grid."""

    fn: Callable[[float], float]
    lo: float = 0.0
    hi: float = float("inf")

    def __call__(self, t: float) -> float:
        return float(np.clip(self.fn(t), self.lo, self.hi))


def constant(v: float) -> Trace:
    return Trace(lambda t: v)


def square_wave(base: float, high: float, period_s: float, duty: float,
                phase_s: float = 0.0) -> Trace:
    """Saturation events: ``high`` for ``duty`` fraction of every period."""

    def fn(t: float) -> float:
        frac = ((t + phase_s) % period_s) / period_s
        return high if frac < duty else base

    return Trace(fn)


def ou_process(seed: int, mu: float, sigma: float, theta: float = 0.5,
               tick_s: float = 0.1, horizon_s: float = 3600.0,
               lo: float = 0.0, hi: float = 1.0) -> Trace:
    """Ornstein-Uhlenbeck fluctuation around ``mu`` (pre-sampled, seeded)."""
    rng = np.random.default_rng(seed)
    n = int(horizon_s / tick_s) + 2
    x = np.empty(n)
    x[0] = mu
    sq = sigma * np.sqrt(tick_s)
    for i in range(1, n):
        x[i] = x[i - 1] + theta * (mu - x[i - 1]) * tick_s + sq * rng.standard_normal()
    x = np.clip(x, lo, hi)

    def fn(t: float) -> float:
        return x[min(int(t / tick_s), n - 1)]

    return Trace(fn, lo, hi)


def diurnal(seed: int, base: float, amp: float, period_s: float = 120.0,
            phase_s: float = 0.0, spike_rate_per_period: float = 1.0,
            spike_amp: float = 0.25, spike_width_s: float = 4.0,
            tick_s: float = 0.1, horizon_s: float = 3600.0,
            lo: float = 0.0, hi: float = 0.99) -> Trace:
    """Diurnal seasonality + seeded flash crowds.

    A sinusoid ``base + amp*sin(2π(t+phase)/period)`` carries the smooth
    daily load cycle the seasonal-naive forecaster is built for, and a
    seeded Poisson set of Gaussian bumps (flash crowds — a stadium letting
    out, a viral clip) rides on top.  Spike onsets/heights are pre-sampled
    from ``seed`` like :func:`ou_process`, so two traces with the same
    arguments are sample-for-sample identical (seed-paired A/Bs).
    """
    rng = np.random.default_rng(seed)
    n_spikes = rng.poisson(spike_rate_per_period * horizon_s / period_s)
    onsets = rng.uniform(0.0, horizon_s, size=n_spikes)
    heights = spike_amp * rng.uniform(0.5, 1.5, size=n_spikes)
    # pre-sample on the tick grid: evaluation stays O(1) per call and the
    # spike sum never re-runs per tick
    n = int(horizon_s / tick_s) + 2
    t_grid = np.arange(n) * tick_s
    x = base + amp * np.sin(2.0 * np.pi * (t_grid + phase_s) / period_s)
    for t0, h in zip(onsets, heights):
        x += h * np.exp(-0.5 * ((t_grid - t0) / spike_width_s) ** 2)
    x = np.clip(x, lo, hi)

    def fn(t: float) -> float:
        return x[min(int(t / tick_s), n - 1)]

    return Trace(fn, lo, hi)


def compose(*traces: Trace, op: str = "add", lo: float = 0.0,
            hi: float = float("inf")) -> Trace:
    def fn(t: float) -> float:
        vals = [tr(t) for tr in traces]
        if op == "add":
            return sum(vals)
        if op == "max":
            return max(vals)
        if op == "mul":
            out = 1.0
            for v in vals:
                out *= v
            return out
        raise ValueError(op)

    return Trace(fn, lo, hi)
