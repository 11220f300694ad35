"""Monitoring & Capacity Profiling (CP) — paper §III-A module 1.

Ingests raw per-node / per-link samples each monitoring cycle, smooths them
(EWMA), and produces (a) the environment state E(t) consumed by
``ShouldReconfigure`` and (b) an updated ``SystemState`` C(t) for the solver.

This module also owns the *measured* half of the capacity story: the
per-(model, segment-shape) profile store (a ``bench-profiles/v1`` JSON
file; the port's own runs write ``BENCH_profiles_torch.json`` through
``repro_torch.launch.profile_segments`` and :class:`repro_torch.serving.
profiler.SegmentProfiler`) and :class:`CalibratedCostModel`, which folds
those measurements over the analytic cost model as per-unit coefficients on
a calibrated graph view.  A model absent from the profile — and in
particular an EMPTY profile — prices bit-identically to
:class:`~repro_torch.core.cost_model.AnalyticCostModel` (``calibrated(g) is
g``).  Numpy and json only, as in the reference, whose module this copies.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .cost_model import AnalyticCostModel, SystemState
from .graph import ModelGraph
from .triggers import EWMA, TriggerState

__all__ = [
    "NodeSample",
    "CapacityProfiler",
    "PROFILE_SCHEMA",
    "SegmentProfileEntry",
    "ModelProfile",
    "SegmentProfile",
    "CalibratedCostModel",
]


@dataclass(frozen=True)
class NodeSample:
    """One raw CP(n_j, t) observation (paper Eq. 1).

    ``util_total`` is what the GPU counters report (other tenants + our own
    inference pods); ``util_background`` excludes our own pods (per-tenant
    cgroup/MIG accounting).  The solver must plan against *background* load —
    planning against total load creates a flee-from-self feedback loop where
    whichever nodes currently host segments always look saturated.
    """

    node: int
    util_total: float           # combined CPU/GPU utilization ∈ [0,1]
    util_background: float      # utilization excluding our own segments
    mem_free_bytes: float = 0.0
    net_egress_bps: float = 0.0


@dataclass
class CapacityProfiler:
    base_state: SystemState
    ewma_alpha: float = 0.3
    _util: dict[int, EWMA] = field(default_factory=dict)
    _util_total: dict[int, EWMA] = field(default_factory=dict)
    _lat: EWMA = field(default_factory=lambda: EWMA(0.3))
    _link_bw: np.ndarray | None = None

    def observe_node(self, s: NodeSample) -> None:
        self._util.setdefault(s.node, EWMA(self.ewma_alpha)).update(s.util_background)
        self._util_total.setdefault(s.node, EWMA(self.ewma_alpha)).update(s.util_total)

    def observe_links(self, bw_matrix_bps: np.ndarray) -> None:
        if self._link_bw is None:
            self._link_bw = bw_matrix_bps.astype(np.float64).copy()
        else:
            a = self.ewma_alpha
            self._link_bw = a * bw_matrix_bps + (1 - a) * self._link_bw

    def observe_latency(self, e2e_latency_s: float) -> None:
        self._lat.update(e2e_latency_s)

    # ------------------------------------------------------------------ #
    def system_state(self) -> SystemState:
        """Updated C(t): base capacities + smoothed live utilization/links."""
        st = self.base_state.copy()
        for node, e in self._util.items():
            st.background_util[node] = np.clip(e.get(st.background_util[node]), 0.0, 0.99)
        if self._link_bw is not None:
            st.link_bw = self._link_bw.copy()
        return st

    def env_state(self) -> TriggerState:
        """E(t) for the trigger check (U_max fires on TOTAL node utilization)."""
        st = self.system_state()
        off_diag = ~np.eye(st.num_nodes, dtype=bool)
        finite = st.link_bw[off_diag]
        finite = finite[np.isfinite(finite)]
        max_total = max(
            (e.get(0.0) for e in self._util_total.values()),
            default=float(st.background_util.max()),
        )
        return TriggerState(
            ewma_latency_s=self._lat.get(0.0),
            max_node_util=float(max_total),
            min_link_bw_bps=float(finite.min()) if finite.size else float("inf"),
        )


# --------------------------------------------------------------------------- #
# measured segment profiles (the data plane feeding the control plane)
# --------------------------------------------------------------------------- #
PROFILE_SCHEMA = "bench-profiles/v1"


@dataclass(frozen=True)
class SegmentProfileEntry:
    """One measured segment [lo, hi) of a profiled model.

    ``step_time_s`` is the wall time of the segment's real forward pass
    (prefill step, ``batch × tokens`` inputs) through the serving chain;
    ``analytic_time_s`` is what :func:`repro_torch.core.cost_model.
    segment_exec_time` predicts for the same segment, workload, and
    profiling-node spec.  ``boundary_bytes_tok`` is the measured wire
    bytes/token leaving the segment (post-compression when the transport
    compresses), 0 for the chain tail; ``analytic_boundary_bytes_tok`` the
    graph's ``boundary_act_bytes`` at that cut.
    """

    lo: int
    hi: int
    step_time_s: float
    analytic_time_s: float
    boundary_bytes_tok: float = 0.0
    analytic_boundary_bytes_tok: float = 0.0

    @property
    def time_ratio(self) -> float:
        return self.step_time_s / max(self.analytic_time_s, 1e-30)

    @property
    def bytes_ratio(self) -> float:
        """measured / analytic boundary bytes; 1.0 where nothing crosses."""
        if self.analytic_boundary_bytes_tok <= 0.0:
            return 1.0
        return self.boundary_bytes_tok / self.analytic_boundary_bytes_tok


@dataclass(frozen=True)
class ModelProfile:
    """All measured segments of one catalog model (at one measured shape)."""

    arch: str
    family: str
    graph_units: int              # unit count of the graph that was measured
    batch: int
    tokens: int
    compressed_transfer: bool
    segments: tuple[SegmentProfileEntry, ...]

    @property
    def compute_scale(self) -> float:
        """Aggregate measured/analytic step-time ratio (time-weighted)."""
        num = sum(s.step_time_s for s in self.segments)
        den = sum(s.analytic_time_s for s in self.segments)
        return num / max(den, 1e-30)

    @property
    def transfer_scale(self) -> float:
        """Aggregate measured/analytic boundary-bytes ratio (byte-weighted)."""
        num = sum(s.boundary_bytes_tok for s in self.segments
                  if s.analytic_boundary_bytes_tok > 0)
        den = sum(s.analytic_boundary_bytes_tok for s in self.segments)
        return num / den if den > 0 else 1.0

    def unit_scales(self, n_units: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-unit (flops_scale, xfer_scale) vectors for an ``n_units`` graph.

        A profile may be measured on a reduced config (the reference's CPU
        runs) or at another depth than the graph it calibrates; the
        measured/analytic *ratio* is the calibration and is assumed
        depth-invariant — kernel efficiency per unit, not absolute time.
        Catalog graphs share the [embed, block_0..L-1, head] unit layout, so
        the mapping anchors by ROLE: target embed/head take the measured
        embed/head ratios (the per-call overhead ratio must not smear across
        blocks when the measured graph is shallow), interior blocks map
        fractionally along the block axis.  Units the measurement never
        covered fall back to the aggregate scales, so partial profiles
        degrade gracefully toward the mean.
        """
        gu = self.graph_units
        # per-measured-unit scales from the segment entries
        mf = np.full(gu, self.compute_scale, dtype=np.float64)
        mx = np.full(gu, self.transfer_scale, dtype=np.float64)
        for s in self.segments:
            mf[s.lo:s.hi] = s.time_ratio
            if s.analytic_boundary_bytes_tok > 0 and 0 < s.hi <= gu:
                # the ratio belongs to the cut at `hi`, i.e. the bytes
                # leaving unit hi-1 (graph.boundary_act_bytes convention)
                mx[s.hi - 1] = s.bytes_ratio
        if n_units == gu:
            return mf.copy(), mx.copy()
        fs = np.full(n_units, self.compute_scale, dtype=np.float64)
        xs = np.full(n_units, self.transfer_scale, dtype=np.float64)
        fs[0], fs[-1] = mf[0], mf[-1]
        xs[0], xs[-1] = mx[0], mx[-1]
        if n_units > 2 and gu > 2:
            for t in range(1, n_units - 1):
                m = 1 + (t - 1) * (gu - 2) // (n_units - 2)
                fs[t] = mf[m]
                xs[t] = mx[m]
        return fs, xs

    def to_doc(self) -> dict:
        return {
            "arch": self.arch,
            "family": self.family,
            "graph_units": self.graph_units,
            "batch": self.batch,
            "tokens": self.tokens,
            "compressed_transfer": self.compressed_transfer,
            "compute_scale": round(self.compute_scale, 6),
            "transfer_scale": round(self.transfer_scale, 6),
            "segments": [dataclasses.asdict(s) for s in self.segments],
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "ModelProfile":
        return cls(
            arch=doc["arch"], family=doc["family"],
            graph_units=int(doc["graph_units"]), batch=int(doc["batch"]),
            tokens=int(doc["tokens"]),
            compressed_transfer=bool(doc.get("compressed_transfer", False)),
            segments=tuple(
                SegmentProfileEntry(
                    lo=int(s["lo"]), hi=int(s["hi"]),
                    step_time_s=float(s["step_time_s"]),
                    analytic_time_s=float(s["analytic_time_s"]),
                    boundary_bytes_tok=float(s.get("boundary_bytes_tok", 0.0)),
                    analytic_boundary_bytes_tok=float(
                        s.get("analytic_boundary_bytes_tok", 0.0)),
                )
                for s in doc["segments"]
            ),
        )


@dataclass
class SegmentProfile:
    """The profile artifact: measured models keyed by arch (= graph name).

    Persisted merge-on-write like ``BENCH_fleet.json``: :meth:`save` folds
    this run's models over whatever the file already holds and stamps the
    refreshed archs, so partial re-profiling never drops coverage.
    """

    models: dict[str, ModelProfile] = field(default_factory=dict)

    def __bool__(self) -> bool:
        return bool(self.models)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "SegmentProfile":
        doc = json.loads(pathlib.Path(path).read_text())
        if doc.get("schema") != PROFILE_SCHEMA:
            raise ValueError(
                f"profile schema {doc.get('schema')!r} != {PROFILE_SCHEMA!r}"
            )
        return cls(models={
            arch: ModelProfile.from_doc(m)
            for arch, m in doc.get("models", {}).items()
        })

    def save(self, path: str | pathlib.Path,
             *, refreshed: Sequence[str] | None = None) -> dict:
        """Merge-on-write persist; returns the document written."""
        p = pathlib.Path(path)
        models: dict[str, dict] = {}
        if p.exists():
            try:
                prev = json.loads(p.read_text())
                if prev.get("schema") == PROFILE_SCHEMA:
                    models = dict(prev.get("models", {}))
            except (json.JSONDecodeError, OSError):
                pass
        for arch, m in self.models.items():
            models[arch] = m.to_doc()
        doc = {
            "schema": PROFILE_SCHEMA,
            "source": "repro_torch.launch.profile_segments",
            "models": dict(sorted(models.items())),
            "refreshed": sorted(refreshed if refreshed is not None
                                else self.models),
        }
        p.write_text(json.dumps(doc, indent=2) + "\n")
        return doc


class CalibratedCostModel(AnalyticCostModel):
    """Analytic cost model with measured per-segment coefficients folded in.

    ``calibrated(graph)`` returns a view of the graph whose per-unit
    ``flops`` carry the measured/analytic step-time ratio and whose
    ``act_out_bytes`` carry the measured/analytic boundary-transfer ratio
    (``weight_bytes`` is untouched — memory feasibility and weight movement
    always price real parameter bytes).  Every Φ-family query inherited from
    :class:`~repro_torch.core.cost_model.CostModel` then evaluates the pinned
    analytic formulas on that view, so calibration flows identically through
    the scalar reference and the splitter DP — they consume the same
    (calibrated) graph arrays.

    A graph whose name has no profile entry — and in particular ANY graph
    under an empty profile — is returned unchanged (``calibrated(g) is g``),
    making the empty-profile provider bit-identical to
    :class:`~repro_torch.core.cost_model.AnalyticCostModel` by construction.
    Calibrated views are cached per source graph and the map is idempotent
    (feeding a calibrated view back in returns it as-is), so repeated
    calibration at different layers can never double-scale.
    """

    def __init__(self, profile: SegmentProfile | None = None) -> None:
        self.profile = profile if profile is not None else SegmentProfile()
        # id(graph) -> (source graph, calibrated view); holding the source
        # reference keeps the id stable for the lifetime of the entry
        self._cache: dict[int, tuple[ModelGraph, ModelGraph]] = {}
        self._made: dict[int, ModelGraph] = {}   # ids of produced views

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "CalibratedCostModel":
        return cls(SegmentProfile.load(path))

    def scales_for(self, graph: ModelGraph) -> tuple[np.ndarray, np.ndarray] | None:
        mp = self.profile.models.get(graph.name)
        return None if mp is None else mp.unit_scales(len(graph))

    def calibrated(self, graph: ModelGraph) -> ModelGraph:
        if id(graph) in self._made:          # already a calibrated view
            return graph
        hit = self._cache.get(id(graph))
        if hit is not None and hit[0] is graph:
            return hit[1]
        scales = self.scales_for(graph)
        if scales is None:                   # analytic fallback, bit-identical
            return graph
        fs, xs = scales
        view = ModelGraph(graph.name, [
            dataclasses.replace(
                u, flops=u.flops * float(fs[i]),
                act_out_bytes=u.act_out_bytes * float(xs[i]))
            for i, u in enumerate(graph.nodes)
        ])
        self._cache[id(graph)] = (graph, view)
        self._made[id(view)] = view
        return view
