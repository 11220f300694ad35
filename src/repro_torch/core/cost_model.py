"""Cost model Φ(x, S, C(t)) = α·L + β·U + γ·P  (paper §III-B).

All quantities are SI: seconds, bytes, FLOP/s, bytes/s.  The system state
C(t) bundles per-node capacities CP(n_j, t) (Eq. 1) and the link matrix;
``phi`` evaluates the paper's objective for a concrete (split, placement).

Latency follows the ETSI-MEC decomposition the paper uses in Eq. 10:

    latency = T_proc + T_queue + T_tx(bandwidth)

* ``T_proc``  per-segment compute on its host, derated by background load,
* ``T_queue`` M/M/1-style congestion factor from the node's total offered load,
* ``T_tx``    boundary activations / link bandwidth + propagation latency.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .graph import ModelGraph

__all__ = [
    "Workload",
    "SystemState",
    "region_slice",
    "CostWeights",
    "CostBreakdown",
    "CostModel",
    "AnalyticCostModel",
    "segment_exec_time",
    "chain_latency",
    "node_loads",
    "utilization_term",
    "privacy_violations",
    "memory_violations",
    "memory_violations_packed",
    "link_loads",
    "phi",
    "evaluate",
]

_EPS = 1e-12
_RHO_CAP = 0.95  # queueing model saturation clamp


def mm1_response_factor(offered_load: float, cap: float = 0.9) -> float:
    """M/M/1 response-time multiplier 1/(1-ρ), ρ clamped at ``cap``.

    Used by the DP solvers as a *per-segment* congestion proxy (the segment's
    own arrival stream against the node's residual capacity), keeping the DP
    objective additive; the exact multi-segment queueing interaction is
    evaluated by ``chain_latency`` during local-search refinement.
    """
    return 1.0 / (1.0 - min(offered_load, cap))


@dataclass(frozen=True)
class Workload:
    """Per-request token counts + steady-state arrival rate (requests/s)."""

    tokens_in: int = 128          # prefill tokens crossing each boundary
    tokens_out: int = 64          # decode tokens (one boundary crossing each)
    arrival_rate: float = 1.0     # λ, requests/s entering the chain

    @property
    def total_tokens(self) -> int:
        return self.tokens_in + self.tokens_out


@dataclass
class SystemState:
    """C(t): node capacities CP(n_j,t) (Eq. 1) + link matrix + trust set.

    ``link_bw[i, j]`` is bytes/s from node i to node j; ``link_lat[i, j]`` is
    one-way propagation seconds.  Diagonals are local (infinite bw, 0 lat).
    ``mem_bw`` is HBM bandwidth — autoregressive *decode* is memory-bound, so
    per-token decode time is max(FLOPs/FLOP rate, weight bytes/HBM rate).
    """

    flops_per_s: np.ndarray        # (n,) effective peak FLOP/s per node
    mem_bytes: np.ndarray          # (n,) model-memory capacity
    background_util: np.ndarray    # (n,) fraction of compute already consumed
    trusted: np.ndarray            # (n,) bool
    link_bw: np.ndarray            # (n, n) bytes/s
    link_lat: np.ndarray           # (n, n) seconds
    mem_bw: np.ndarray | None = None  # (n,) HBM bytes/s (default: flops/150)
    names: tuple[str, ...] = field(default_factory=tuple)
    # MEC-region membership: ``region_of[i]`` is node i's region id,
    # contiguous 0..R-1.  Host-side metadata only — the pricing programs
    # never see it; the region-sharded control plane slices C(t) into
    # per-region states with it (:func:`region_slice`).  ``None`` means the
    # whole state is one region.
    region_of: np.ndarray | None = None

    def __post_init__(self) -> None:
        n = self.num_nodes
        if self.mem_bw is None:
            # default arithmetic-intensity knee of ~150 FLOP/byte
            self.mem_bw = np.asarray(self.flops_per_s, dtype=np.float64) / 150.0
        for arr, shape in [
            (self.flops_per_s, (n,)), (self.mem_bytes, (n,)),
            (self.background_util, (n,)), (self.trusted, (n,)),
            (self.link_bw, (n, n)), (self.link_lat, (n, n)),
            (self.mem_bw, (n,)),
        ]:
            if np.asarray(arr).shape != shape:
                raise ValueError(f"state array shape {np.asarray(arr).shape} != {shape}")
        if self.region_of is not None:
            self.region_of = np.asarray(self.region_of, dtype=np.int64)
            if self.region_of.shape != (n,):
                raise ValueError(
                    f"region_of shape {self.region_of.shape} != ({n},)")
            r = np.unique(self.region_of)
            if r.min() != 0 or not np.array_equal(r, np.arange(len(r))):
                raise ValueError("region ids must be contiguous 0..R-1")
        if not self.names:
            self.names = tuple(f"node{i}" for i in range(n))

    @property
    def num_nodes(self) -> int:
        return int(np.asarray(self.flops_per_s).shape[0])

    @property
    def num_regions(self) -> int:
        return (1 if self.region_of is None
                else int(self.region_of.max()) + 1)

    def copy(self) -> "SystemState":
        return SystemState(
            self.flops_per_s.copy(), self.mem_bytes.copy(),
            self.background_util.copy(), self.trusted.copy(),
            self.link_bw.copy(), self.link_lat.copy(),
            None if self.mem_bw is None else self.mem_bw.copy(), self.names,
            None if self.region_of is None else self.region_of.copy(),
        )


def region_slice(state: SystemState, nodes: np.ndarray) -> SystemState:
    """C(t) restricted to one region's node subset.

    ``nodes`` are GLOBAL node indices (ascending); the returned state is
    the block-diagonal slice in LOCAL coordinates — the region-sharded
    control plane places every session on its own region's nodes only, so
    the inter-region rows/columns it drops carry no session traffic and
    the slice is an exact view, not an approximation.  ``region_of`` is
    dropped (a single region IS the whole sliced state).
    """
    ix = np.asarray(nodes, dtype=np.int64)
    return SystemState(
        np.asarray(state.flops_per_s, dtype=np.float64)[ix].copy(),
        np.asarray(state.mem_bytes, dtype=np.float64)[ix].copy(),
        np.asarray(state.background_util, dtype=np.float64)[ix].copy(),
        np.asarray(state.trusted)[ix].copy(),
        np.asarray(state.link_bw, dtype=np.float64)[np.ix_(ix, ix)].copy(),
        np.asarray(state.link_lat, dtype=np.float64)[np.ix_(ix, ix)].copy(),
        None if state.mem_bw is None
        else np.asarray(state.mem_bw, dtype=np.float64)[ix].copy(),
        tuple(state.names[int(i)] for i in ix) if state.names else (),
    )


@dataclass(frozen=True)
class CostWeights:
    """α, β, γ ≥ 0 — relative importance of latency / utilization / privacy."""

    alpha: float = 1.0
    beta: float = 0.05
    gamma: float = 1000.0  # privacy is near-hard: one violation dwarfs latency


@dataclass(frozen=True)
class CostBreakdown:
    latency: float
    utilization: float
    privacy: float
    weights: CostWeights
    t_proc: float = 0.0
    t_queue: float = 0.0
    t_tx: float = 0.0
    node_rho: tuple[float, ...] = ()

    @property
    def total(self) -> float:
        w = self.weights
        return w.alpha * self.latency + w.beta * self.utilization + w.gamma * self.privacy


# --------------------------------------------------------------------------- #
# latency L(x, C(t))
# --------------------------------------------------------------------------- #
def segment_service_time(
    seg_flops: float, seg_wbytes: float, node: int, state: SystemState, wl: Workload,
    *, derate: bool = True,
) -> float:
    """T_proc for a segment on ``node``.

    Prefill is compute-bound: tokens_in · FLOPs/token / FLOP-rate.
    Decode is roofline-priced per token: max(FLOPs/FLOP-rate, weights/HBM-rate)
    — an 8B bf16 model streams ~16 GB of weights per decoded token.
    """
    d = max(_EPS, 1.0 - state.background_util[node]) if derate else 1.0
    f = max(state.flops_per_s[node] * d, _EPS)
    m = max(state.mem_bw[node] * d, _EPS)
    t_prefill = wl.tokens_in * seg_flops / f
    t_decode = wl.tokens_out * max(seg_flops / f, seg_wbytes / m)
    return t_prefill + t_decode


def segment_exec_time(
    graph: ModelGraph, lo: int, hi: int, node: int, state: SystemState, wl: Workload
) -> float:
    """T_proc for segment [lo,hi) on ``node`` (derated by background load)."""
    return segment_service_time(
        graph.segment_flops(lo, hi), graph.segment_weight_bytes(lo, hi),
        node, state, wl,
    )


def _transfer_time(bytes_: float, src: int, dst: int, state: SystemState) -> float:
    if src == dst:
        return 0.0
    bw = state.link_bw[src, dst]
    return bytes_ / max(bw, _EPS) + state.link_lat[src, dst]


def node_loads(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
) -> np.ndarray:
    """Total node utilization: background + λ · Σ raw service times (KPI/trigger)."""
    rho = state.background_util.astype(np.float64).copy()
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        node = assignment[j]
        svc = segment_service_time(
            graph.segment_flops(lo, hi), graph.segment_weight_bytes(lo, hi),
            node, state, wl, derate=False,
        )
        rho[node] += wl.arrival_rate * svc
    return rho


def node_queue_loads(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
) -> np.ndarray:
    """M/M/1 offered load ρ_q = λ · Σ *derated* service times.

    The background tenants shrink the server to (1-bg)·capacity; our own
    arrival stream then queues against that residual server.  ρ_q ≥ 1 means
    the node cannot sustain the inference arrival rate at all.
    """
    rho = np.zeros(state.num_nodes)
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        node = assignment[j]
        svc = segment_service_time(
            graph.segment_flops(lo, hi), graph.segment_weight_bytes(lo, hi),
            node, state, wl, derate=True,
        )
        rho[node] += wl.arrival_rate * svc
    return rho


def link_loads(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
) -> np.ndarray:
    """Per-link utilization ρ_(i,j) = λ · boundary bytes / bandwidth."""
    n = state.num_nodes
    rho = np.zeros((n, n))
    for j in range(1, len(assignment)):
        src, dst = assignment[j - 1], assignment[j]
        if src == dst:
            continue
        bytes_ = graph.boundary_act_bytes(boundaries[j]) * wl.total_tokens
        rho[src, dst] += wl.arrival_rate * bytes_ / max(state.link_bw[src, dst], _EPS)
    return rho


def chain_latency(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
    *,
    return_parts: bool = False,
):
    """End-to-end request latency through the segment chain (Eq. 10)."""
    rho = node_loads(graph, boundaries, assignment, state, wl)
    rho_q = node_queue_loads(graph, boundaries, assignment, state, wl)
    t_proc = t_queue = t_tx = 0.0
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        node = assignment[j]
        svc = segment_exec_time(graph, lo, hi, node, state, wl)
        t_proc += svc
        # M/M/1 congestion: waiting ≈ ρ_q/(1-ρ_q) · service, ρ_q clamped below 1
        r = min(float(rho_q[node]), _RHO_CAP)
        t_queue += svc * r / (1.0 - r)
        if j > 0:
            bnd = boundaries[j]
            bytes_ = graph.boundary_act_bytes(bnd) * (wl.tokens_in + wl.tokens_out)
            t_tx += _transfer_time(bytes_, assignment[j - 1], node, state)
    total = t_proc + t_queue + t_tx
    if return_parts:
        return total, (t_proc, t_queue, t_tx, rho)
    return total


# --------------------------------------------------------------------------- #
# utilization U(x) and privacy P(x)
# --------------------------------------------------------------------------- #
def utilization_term(rho: np.ndarray) -> float:
    """Imbalance/overload: max load + spread (paper: 'imbalance or overload')."""
    return float(np.max(rho) + np.std(rho))


def privacy_violations(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
) -> int:
    """Count of privacy-critical segments on untrusted nodes (Eq. 5/9)."""
    count = 0
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        if graph.segment_has_private(lo, hi) and not state.trusted[assignment[j]]:
            count += 1
    return count


def memory_violations(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
) -> np.ndarray:
    """Per-node bytes over capacity (constraint Eq. 4); 0 where feasible."""
    used = np.zeros(state.num_nodes)
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        used[assignment[j]] += graph.segment_weight_bytes(lo, hi)
    return np.maximum(0.0, used - state.mem_bytes)


def memory_violations_packed(
    seg_wbytes: np.ndarray,
    seg_node: np.ndarray,
    valid: np.ndarray,
    mem_bytes: np.ndarray,
) -> np.ndarray:
    """Batched Eq. 4: per-(session, node) bytes over capacity, vectorized.

    ``seg_wbytes`` / ``seg_node`` / ``valid`` are (B, K) packed session rows
    (the :class:`repro_torch.core.fleet_eval.PackedSessions` layout); ``mem_bytes``
    is (B, n) per-session residual capacity or (n,) shared.  One shot of
    scatter-adds replaces B :func:`memory_violations` loops.  Returns (B, n).
    """
    seg_wbytes = np.asarray(seg_wbytes, dtype=np.float64)
    seg_node = np.asarray(seg_node)
    valid = np.asarray(valid, dtype=bool)
    mem = np.asarray(mem_bytes, dtype=np.float64)
    B, K = seg_wbytes.shape
    n = mem.shape[-1]
    used = np.zeros((B, n))
    rows = np.repeat(np.arange(B), K)
    np.add.at(used, (rows, seg_node.ravel()),
              np.where(valid, seg_wbytes, 0.0).ravel())
    return np.maximum(0.0, used - mem)


# --------------------------------------------------------------------------- #
# Φ
# --------------------------------------------------------------------------- #
def phi(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
    weights: CostWeights = CostWeights(),
) -> CostBreakdown:
    lat, (t_proc, t_queue, t_tx, rho) = chain_latency(
        graph, boundaries, assignment, state, wl, return_parts=True
    )
    return CostBreakdown(
        latency=lat,
        utilization=utilization_term(rho),
        privacy=float(privacy_violations(graph, boundaries, assignment, state)),
        weights=weights,
        t_proc=t_proc,
        t_queue=t_queue,
        t_tx=t_tx,
        node_rho=tuple(float(r) for r in rho),
    )


def evaluate(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
    weights: CostWeights = CostWeights(),
    *,
    mem_penalty: float = 1e3,
) -> float:
    """Scalar Φ including a soft memory-capacity penalty (per GB overflow)."""
    cb = phi(graph, boundaries, assignment, state, wl, weights)
    over = float(memory_violations(graph, boundaries, assignment, state).sum())
    return cb.total + mem_penalty * over / 1e9


# --------------------------------------------------------------------------- #
# pricing provider — the one cost surface the control plane consumes
# --------------------------------------------------------------------------- #
class CostModel:
    """Provider object behind every Φ-family query the control plane makes.

    The free functions above stay the pinned scalar reference; a ``CostModel``
    is how the splitters and the fleet control plane select their pricing
    with one constructor argument.
    The contract hangs on :meth:`calibrated`: it maps a model graph to the
    graph the analytic formulas should be evaluated ON.  The analytic
    provider returns the graph unchanged (``calibrated(g) is g``).
    """

    def calibrated(self, graph: ModelGraph) -> ModelGraph:
        """The graph the analytic formulas should price (identity here)."""
        return graph

    # ---- Φ family, evaluated on the calibrated view ------------------- #
    def segment_exec_time(
        self, graph: ModelGraph, lo: int, hi: int, node: int,
        state: SystemState, wl: Workload,
    ) -> float:
        return segment_exec_time(self.calibrated(graph), lo, hi, node, state, wl)

    def chain_latency(
        self,
        graph: ModelGraph,
        boundaries: Sequence[int],
        assignment: Sequence[int],
        state: SystemState,
        wl: Workload,
        *,
        return_parts: bool = False,
    ):
        return chain_latency(
            self.calibrated(graph), boundaries, assignment, state, wl,
            return_parts=return_parts,
        )

    def phi(
        self,
        graph: ModelGraph,
        boundaries: Sequence[int],
        assignment: Sequence[int],
        state: SystemState,
        wl: Workload,
        weights: CostWeights = CostWeights(),
    ) -> CostBreakdown:
        return phi(self.calibrated(graph), boundaries, assignment, state, wl,
                   weights)

    def evaluate(
        self,
        graph: ModelGraph,
        boundaries: Sequence[int],
        assignment: Sequence[int],
        state: SystemState,
        wl: Workload,
        weights: CostWeights = CostWeights(),
        *,
        mem_penalty: float = 1e3,
    ) -> float:
        return evaluate(self.calibrated(graph), boundaries, assignment, state,
                        wl, weights, mem_penalty=mem_penalty)


class AnalyticCostModel(CostModel):
    """The paper's analytic model, unmodified — the pinned default provider."""
