"""Short-horizon capacity forecasting for the fleet control plane.

The paper frames orchestration as optimization "subject to evolving latency,
utilization, and privacy gradients", and companion work calls for *model-aware
capacity profiling* feeding placement (arXiv:2504.03668) and for control loops
that anticipate load instead of reacting to it (Splitwise, arXiv:2512.23310).
Until now every consumer of C(t) — admission pricing, trigger evaluation,
migration targets — saw only the instantaneous snapshot, so sessions admitted
in a background-load trough transiently pushed the home MEC past ρ = 1 when
the next saturation spike landed.

The predictor is deliberately a strong *baseline*, not a learned model:

* **Seasonal-naive** — the edge background-load signal of interest (tenant
  saturation events on a base station) is periodic; a ring buffer holding the
  last ``season_steps`` samples predicts step ``t + h`` as the sample from one
  season earlier, ``y(t + h - S)``.  After one full observed period this
  reproduces a periodic signal exactly.
* **EWMA residual** — a slowly-adapted bias term ``r ← a·(y - ŷ) + (1-a)·r``
  absorbs level shifts the seasonal lookup cannot (e.g. an OU-wandering
  backhaul with no true period).  Under bounded noise the residual stays
  bounded by construction (it is a convex combination of past one-step
  errors).

State is **device-resident** (float64 torch tensors on the forecaster's
device) and the per-cycle update is plain tensor code —
:func:`seasonal_update` / :func:`seasonal_forecast` /
:func:`worst_case_capacity` are the single source of truth, called both by
the fused :meth:`~repro_torch.core.fleet_eval.ResidentFleetKernel.price`
program and by the standalone :meth:`CapacityForecaster.observe` driver used
by tests and non-fleet callers.  The ring position, sample count and advance
gate are host scalars: they change once per sample interval.

Consumer: :meth:`~repro_torch.core.fleet.FleetOrchestrator.step` raises
*proactive* triggers when a session's forecast latency/util/bandwidth would
cross its Θ within the horizon, and prices migration candidates against the
forecast C(t+h) so nothing migrates ONTO an about-to-spike node.

``horizon_steps = 0`` is the contractual off-switch: every forecast quantity
degenerates to the current value and the control plane is bit-identical to
the reactive path (A/B-equivalence-tested).
"""


from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "ForecastConfig",
    "CapacityForecaster",
    "seasonal_update",
    "seasonal_forecast",
    "worst_case_capacity",
]

_UTIL_CAP = 0.99  # background-utilization clip shared with the cost model


@dataclass(frozen=True)
class ForecastConfig:
    """Knobs for the seasonal-naive + EWMA-residual predictor.

    ``season_steps`` is the period of the signal in *samples* (the §IV
    home-MEC saturation square wave has a 40 s period and the monitoring
    cadence is 1 s → 40).  ``horizon_steps`` is H: how many future samples
    the worst-case capacity reduction covers; 0 disables forecasting
    entirely (bit-identical reactive behavior).  ``sample_interval_s`` gates
    ring advancement so multiple pricing dispatches within one monitoring
    interval observe, but do not re-append, the same sample.
    """

    horizon_steps: int = 12
    season_steps: int = 40
    sample_interval_s: float = 1.0
    residual_alpha: float = 0.2

    def __post_init__(self) -> None:
        if self.season_steps < 1:
            raise ValueError("season_steps must be >= 1")
        if not 0 <= self.horizon_steps <= self.season_steps:
            raise ValueError(
                f"horizon_steps must be in [0, season_steps={self.season_steps}]"
            )


# --------------------------------------------------------------------------- #
# tensor update/predict — shared by the fused pricing and the host driver
# --------------------------------------------------------------------------- #
def seasonal_update(ring: torch.Tensor, resid: torch.Tensor, idx: int,
                    count: int, y: torch.Tensor, advance: bool, alpha: float):
    """One observation step: residual EWMA against the season-old prediction,
    then write ``y`` into slot ``idx``.

    ``ring`` is (S, *shape) with slot ``p`` holding the most recent sample
    taken at a step ≡ p (mod S); ``resid`` matches ``y``'s shape.  ``idx`` /
    ``count`` / ``advance`` are host scalars.  When ``advance`` is false the
    inputs pass through unchanged (a read-only pricing dispatch).  Returns
    ``(ring', resid')``; the inputs are not modified.

    Non-finite elements of ``y`` are skipped element-wise: a poisoned
    element keeps its season-old ring value and its previous residual
    (skip-and-hold, bit-identical for finite inputs), so one NaN sample can
    never make every later forecast of that node NaN.
    """
    S = ring.shape[0]
    if not advance:
        return ring, resid
    yhat = ring[idx]                      # prediction made one season ago
    ok = torch.isfinite(y)
    y_safe = torch.where(ok, y, yhat)     # poisoned element: hold the prior
    if count >= S:                        # slot idx only valid after 1 season
        resid = torch.where(
            ok, alpha * (y_safe - yhat) + (1.0 - alpha) * resid, resid)
    ring = ring.clone()
    ring[idx] = y_safe
    return ring, resid


def seasonal_forecast(ring: torch.Tensor, resid: torch.Tensor, idx: int,
                      horizon: int) -> torch.Tensor:
    """(H, *shape) predictions for steps t+1 … t+H, taken AFTER the step-t
    write: ŷ(t+h) = ring[(idx + h) mod S] + resid — the sample from time
    t + h − S plus the residual bias.  Requires 1 ≤ H ≤ S (slot t+h−S is
    still un-overwritten exactly when h ≤ S)."""
    S = ring.shape[0]
    slots = [(idx + 1 + h) % S for h in range(horizon)]
    return ring[slots] + resid[None]


def worst_case_capacity(util_ring, resid_u, bw_ring, resid_b, idx: int,
                        count: int, y_util, y_bw, horizon: int):
    """(bg_wc (n,), bw_wc (n, n)): the capacity floor over the next H steps.

    Element-wise MAX background utilization and MIN link bandwidth over
    {now} ∪ {forecast t+1 … t+H} — "min over the horizon of forecast
    residual capacity".  Until one full season has been observed
    (``count < S``, counted AFTER the current write) or with H = 0, both
    collapse to the current values: the consumer silently degrades to
    reactive behavior instead of trusting an unseeded ring.
    """
    if horizon == 0 or count < util_ring.shape[0]:
        return y_util, y_bw
    fc_u = torch.clamp(seasonal_forecast(util_ring, resid_u, idx, horizon),
                       0.0, _UTIL_CAP)
    fc_b = torch.clamp_min(seasonal_forecast(bw_ring, resid_b, idx, horizon),
                           0.0)
    return (torch.maximum(y_util, fc_u.amax(dim=0)),
            torch.minimum(y_bw, fc_b.amin(dim=0)))


# --------------------------------------------------------------------------- #
# host-side controller owning the device rings
# --------------------------------------------------------------------------- #
class CapacityForecaster:
    """Owns the device-resident forecast state and its advancement cadence.

    The ring/residual tensors live on ``device`` between cycles, like
    :class:`~repro_torch.core.fleet_eval.FleetStateBuffers`; the fused
    pricing threads them through one call per cycle (:meth:`kernel_args` →
    price → :meth:`commit`).  ``idx`` / ``count`` / ``_last_t`` stay
    host-side — they change once per sample interval.

    :meth:`observe` is the standalone driver (tests, single-session callers
    without a resident kernel): the SAME tensor update/predict helpers run
    on the same device, so the two paths cannot drift.
    """

    def __init__(self, config: ForecastConfig = ForecastConfig(), *,
                 device: str | torch.device = "cuda") -> None:
        self.cfg = config
        self.device = resolve_device(device)
        self.idx = 0
        self.count = 0
        self._last_t = float("-inf")
        self._pending_steps = 0    # ring slots the in-flight dispatch spans
        self._pending_credit = 0   # warm-up credit for those slots
        self.util_ring = None          # (S, n) device
        self.bw_ring = None            # (S, n, n) device
        self.resid_util = None         # (n,) device
        self.resid_bw = None           # (n, n) device
        # host copies of the latest worst-case capacity (admission pricing)
        self.bg_wc: np.ndarray | None = None
        self.bw_wc: np.ndarray | None = None
        # non-finite sample elements skipped by the update guard (counted
        # where the sample is host-visible; the fused path skips silently)
        self.bad_samples = 0

    def to(self, device: str | torch.device) -> "CapacityForecaster":
        """Move the rings (if any) and all later state to ``device``."""
        self.device = resolve_device(device)
        for name in ("util_ring", "bw_ring", "resid_util", "resid_bw"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.to(self.device))
        return self

    # -- state ---------------------------------------------------------- #
    @property
    def enabled(self) -> bool:
        """False only for the degenerate H = 0 configuration."""
        return self.cfg.horizon_steps > 0

    @property
    def ready(self) -> bool:
        """One full season observed — forecasts are live (H > 0 only)."""
        return self.enabled and self.count >= self.cfg.season_steps

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)

    def ensure(self, n: int) -> None:
        if self.util_ring is not None:
            return
        S = self.cfg.season_steps
        f64 = dict(dtype=torch.float64, device=self.device)
        self.util_ring = torch.zeros((S, n), **f64)
        self.bw_ring = torch.zeros((S, n, n), **f64)
        self.resid_util = torch.zeros(n, **f64)
        self.resid_bw = torch.zeros((n, n), **f64)

    def _advance_steps(self, now: float | None) -> int:
        """Whole sample intervals elapsed since the last committed sample
        (0 = cadence-gated read-only dispatch; clamped at one season)."""
        if now is None:
            return 0
        if self._last_t == float("-inf"):
            return 1
        steps = int((now - self._last_t + 1e-9)
                    // self.cfg.sample_interval_s)
        return max(0, min(steps, self.cfg.season_steps))

    def should_advance(self, now: float | None) -> bool:
        """True iff a dispatch at ``now`` appends a fresh sample (does not
        mutate state — :meth:`commit` records the advancement)."""
        return self._advance_steps(now) > 0

    def kernel_args(self, n: int, now: float | None):
        """(forecast inputs, advance) for one fused pricing call.

        Phase alignment is wall-clock anchored: a stalled or jittered
        monitoring loop that skips sample intervals advances the ring by
        the MISSED step count, so slot ``p`` keeps meaning "time ≡ p
        (mod S)" — the write lands in the slot for ``now``, and (once warm)
        the skipped slots simply retain their season-old values, i.e. the
        seasonal prior.  A gap during WARM-UP instead restarts the count:
        ``ready`` must never trust slots that were skipped before they
        were ever written.
        """
        self.ensure(n)
        steps = self._advance_steps(now)
        if steps > 1 and not self.ready:
            self.count = 0
        # the slot for `now` (idx is the next contiguous write position)
        write_idx = ((self.idx + steps - 1) % self.cfg.season_steps
                     if steps else self.idx)
        self._pending_steps = steps
        self._pending_credit = 1 if (steps > 1 and not self.ready) else steps
        return (
            self.util_ring, self.bw_ring, self.resid_util, self.resid_bw,
            write_idx, self.count, steps > 0,
        ), steps > 0

    def commit(self, util_ring, bw_ring, resid_util, resid_bw,
               bg_wc, bw_wc, *, advance: bool, now: float | None) -> None:
        """Adopt one call's outputs (rings stay on device; the worst-case
        vectors come to the host for the admission control plane)."""
        self.util_ring = util_ring
        self.bw_ring = bw_ring
        self.resid_util = resid_util
        self.resid_bw = resid_bw
        n = bg_wc.shape[0]
        wc = torch.cat([bg_wc.reshape(-1), bw_wc.reshape(-1)]).cpu().numpy()
        self.bg_wc = wc[:n].copy()
        self.bw_wc = wc[n:].reshape(n, n).copy()
        steps = self._pending_steps
        if advance and steps:
            dt = self.cfg.sample_interval_s
            self.idx = (self.idx + steps) % self.cfg.season_steps
            self.count += self._pending_credit
            # stay wall-aligned: advance by whole intervals so sub-interval
            # jitter (e.g. steady 1.05 s cycles) cannot accumulate into
            # phase drift; re-anchor only on the first sample or when the
            # clamp left us more than an interval behind
            anchored = self._last_t + steps * dt
            if self._last_t == float("-inf") or now - anchored >= dt:
                self._last_t = float(now)
            else:
                self._last_t = anchored
            self._pending_steps = 0
            self._pending_credit = 0

    # -- persistence across restarts ------------------------------------ #
    def state_dict(self) -> dict[str, np.ndarray]:
        """Host-side snapshot of the seasonal state (empty pre-``ensure``).

        A restart mid-storm would otherwise reset ``count`` to zero,
        disabling proactive triggers for a full season exactly when capacity
        is most volatile; persisting the ring closes that blind window.
        """
        if self.util_ring is None:
            return {}
        return {
            "util_ring": self.util_ring.cpu().numpy().copy(),
            "bw_ring": self.bw_ring.cpu().numpy().copy(),
            "resid_util": self.resid_util.cpu().numpy().copy(),
            "resid_bw": self.resid_bw.cpu().numpy().copy(),
            "idx": np.asarray(self.idx, dtype=np.int64),
            "count": np.asarray(self.count, dtype=np.int64),
            "last_t": np.asarray(self._last_t, dtype=np.float64),
            "season_steps": np.asarray(self.cfg.season_steps, dtype=np.int64),
        }

    def load_state_dict(self, d: dict) -> None:
        """Seed the rings from a snapshot; ``ready`` carries over.

        The season length is structural (slot p means "time ≡ p mod S"), so
        a mismatched snapshot is an error, not a silent re-warm-up.
        """
        if not d:
            return
        S = int(np.asarray(d["season_steps"]))
        if S != self.cfg.season_steps:
            raise ValueError(
                f"snapshot season_steps={S} != configured "
                f"{self.cfg.season_steps}")
        self.util_ring = self._tensor(d["util_ring"])
        self.bw_ring = self._tensor(d["bw_ring"])
        self.resid_util = self._tensor(d["resid_util"])
        self.resid_bw = self._tensor(d["resid_bw"])
        self.idx = int(np.asarray(d["idx"]))
        self.count = int(np.asarray(d["count"]))
        self._last_t = float(np.asarray(d["last_t"]))

    def save(self, path) -> None:
        """Persist the seasonal state to an ``.npz`` file (no-op pre-warm)."""
        sd = self.state_dict()
        if sd:
            np.savez(path, **sd)

    def load(self, path) -> bool:
        """Seed from :meth:`save` output; returns whether state was loaded."""
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        self.load_state_dict(d)
        return bool(d)

    # -- standalone driver (no resident kernel) ------------------------- #
    def observe(self, now: float, bg_util: np.ndarray,
                link_bw: np.ndarray | None = None) -> bool:
        """Feed one (background-util, link-bw) sample directly.

        Runs the shared update/worst-case helpers — identical math to the
        fused pricing path.  Returns whether the sample advanced the ring
        (False → cadence-gated no-op)."""
        bg = np.asarray(bg_util, dtype=np.float64)
        n = bg.shape[0]
        bw = (np.full((n, n), np.inf) if link_bw is None
              else np.asarray(link_bw, dtype=np.float64))
        self.bad_samples += int((~np.isfinite(bg)).sum()
                                + np.isnan(bw).sum())
        # +inf is the legitimate "local link" encoding → clamp to BIG; NaN
        # is poison → keep it NaN so the update guard skips-and-holds
        bw = np.nan_to_num(bw, nan=np.nan, posinf=1e30)
        (args, adv) = self.kernel_args(n, now)
        util_ring, bw_ring, resid_u, resid_b, idx, count, advance = args
        a = self.cfg.residual_alpha
        y_u, y_b = self._tensor(bg), self._tensor(bw)
        util_ring2, resid_u2 = seasonal_update(
            util_ring, resid_u, idx, count, y_u, advance, a)
        bw_ring2, resid_b2 = seasonal_update(
            bw_ring, resid_b, idx, count, y_b, advance, a)
        # count advances only by the committed credit — a cadence-gated
        # call at count == S-1 must NOT flip `ready` a sample early, and a
        # warm-up gap restart must not double-count its slots
        bg_wc, bw_wc = worst_case_capacity(
            util_ring2, resid_u2, bw_ring2, resid_b2, idx,
            count + self._pending_credit,
            y_u, y_b, self.cfg.horizon_steps)
        self.commit(util_ring2, bw_ring2, resid_u2, resid_b2, bg_wc, bw_wc,
                    advance=adv, now=now)
        return adv

    def predict_util(self) -> np.ndarray:
        """(H, n) background-utilization forecast for t+1 … t+H (host copy,
        residual-corrected, unclipped readiness: caller checks ``ready``)."""
        if self.util_ring is None or not self.enabled:
            raise RuntimeError("forecaster has no samples / horizon is 0")
        # anchor at the slot LAST WRITTEN (self.idx is the next write
        # position): predictions cover last-observed+1 … last-observed+H,
        # matching the in-dispatch semantics where the forecast is taken
        # right after the cycle's sample lands
        idx_last = (self.idx - 1) % self.cfg.season_steps
        fc = seasonal_forecast(self.util_ring, self.resid_util, idx_last,
                               self.cfg.horizon_steps)
        return fc.cpu().numpy()
