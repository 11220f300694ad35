"""Fleet-wide batched cost evaluation, migration DP, repair and fixed point.

The fleet monitoring cycle prices every live session, and re-places the
triggered ones, each cycle.  This module batches both halves across the
session set, as :class:`~repro_torch.core.splitter.BatchedJointSplitter`
batches re-splits:

* :func:`pack_sessions` — pad the per-session (segment, placement, workload)
  tensors to a shared ``(B, K)`` layout (power-of-two padded on both axes,
  the reference's layout, so rows match it row for row).
* :func:`packed_induced_loads` — vectorized numpy fold of every session's
  induced node ρ / link ρ / resident weights (the host reference).
* :class:`FleetCostEvaluator` — a batched mirror of
  :func:`repro_torch.core.cost_model.chain_latency` and
  :func:`repro_torch.core.cost_model.evaluate`: one call prices the whole
  fleet, each session against its own effective background-utilization vector
  and link matrix, in float64 on the evaluator's device.
* :class:`BatchedMigrationSolver` — the placement chain DP (Eq. 7: fixed
  boundaries, choose nodes) over a leading session axis with per-step
  validity masking.
* :class:`BatchedRepairPass` — the greedy Eq. 4 memory repair, batched.
* :class:`FleetStateBuffers` — sessions as ROWS of long-lived device
  tensors, updated row-wise on admit / depart / commit.
* :class:`ResidentFleetKernel` — the fused monitoring-step programs over the
  resident rows: ``price`` (induced loads → effective C(t) → batched Φ →
  per-session trigger env, with the seasonal forecast update riding along),
  ``migrate`` (DP + device backtrack + repair + candidate pricing) and
  ``migrate_fixed_point`` (the red/black joint reconfiguration).
* :class:`ShardedFleetState` — one (buffers, kernel) pair per MEC region and
  the cross-shard screen: ``price`` applied over a leading shard axis
  (``torch.func.vmap``), every shard against its own regional C(t), in one
  call per cycle.

Every program is plain float64 / int64 / bool tensor code on one device.
Loops over the padded segment count K replace the reference's scans, and the
red/black loop runs on the host with one scalar read per sweep.

Determinism: the induced-load folds never use atomic float accumulation.
Each row writes one place per segment, so :func:`_scatter_rows` adds the K
segment slots one slot at a time — no two writes of one step collide, and
every sum runs in the reference's segment order.  Fleet totals are plain
reductions.  Two runs on one device therefore give bit-identical tables.

**Lifecycle / ownership**: a :class:`~repro_torch.core.fleet.FleetOrchestrator`
owns exactly one :class:`FleetStateBuffers`; the orchestrator's ``admit`` /
``depart`` / ``_commit`` are the only writers.  A cold rebuild
(:meth:`FleetStateBuffers.from_sessions`) is bit-identical to the
incremental rows.
"""

from __future__ import annotations

import functools
import itertools
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .cost_model import (_EPS, _RHO_CAP, AnalyticCostModel, CostModel,
                         CostWeights, SystemState, Workload)
from .forecast import seasonal_update, worst_case_capacity
from .graph import ModelGraph
from .placement import Solution

__all__ = [
    "PackedSessions",
    "pack_sessions",
    "packed_induced_loads",
    "FleetCostEvaluator",
    "BatchedMigrationSolver",
    "BatchedRepairPass",
    "FleetStateBuffers",
    "FixedPointResult",
    "ResidentFleetKernel",
    "ResidentPrice",
    "ShardScreen",
    "ShardedFleetState",
    "gather_rows",
    "to_host",
]

_BIG = 1e30

_F64 = torch.float64

# process-wide mutation stamps for FleetStateBuffers (see .version)
_BUF_VERSIONS = itertools.count(1)


def _pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def to_host(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Copy tensors to host numpy arrays with ONE device→host transfer.

    Every tensor is flattened into one float64 buffer (node ids, counts and
    masks are exact in float64), copied once, and split back into arrays of
    its own shape and dtype — the per-cycle host traffic is one copy per
    output group, never one ``.item()`` per row.
    """
    flat = torch.cat([t.reshape(-1).to(_F64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        m = t.numel()
        a = flat[off:off + m].reshape(tuple(t.shape))
        if t.dtype == torch.bool:
            a = a != 0.0
        elif not t.dtype.is_floating_point:
            a = a.astype(np.int64)
        else:
            a = a.copy()
        out.append(a)
        off += m
    return tuple(out)


def gather_rows(rows: Sequence[int], *arrays: torch.Tensor
                ) -> tuple[np.ndarray, ...]:
    """Fetch a row subset of device tensors to host in one transfer.

    The per-cycle host round-trip is O(triggered set), not O(fleet): the
    rows are gathered on the device and copied together (:func:`to_host`).
    """
    if not arrays:
        return ()
    ix = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                         device=arrays[0].device)
    return to_host(*(a[ix] for a in arrays))


def _scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """(B, n) with ``out[b, idx[b, k]] += vals[b, k]``, summed in k order.

    The deterministic replacement for a scatter-add: one gather + add + put
    per segment slot k.  Rows are distinct within a slot, so no write of a
    step collides, and every (row, node) sum runs 0 + v_0 + v_1 + … in the
    reference's order.  No atomic float accumulation is involved.
    """
    B = idx.shape[0]
    out = vals.new_zeros((B, n))
    rows = torch.arange(B, device=idx.device)
    for k in range(idx.shape[1]):
        out[rows, idx[:, k]] += vals[:, k]
    return out


def _scatter_links(src: torch.Tensor, dst: torch.Tensor, vals: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(B, n, n) with ``out[b, src[b, k], dst[b, k]] += vals[b, k]`` in k
    order (see :func:`_scatter_rows`)."""
    B = src.shape[0]
    out = vals.new_zeros((B, n, n))
    rows = torch.arange(B, device=src.device)
    for k in range(src.shape[1]):
        out[rows, src[:, k], dst[:, k]] += vals[:, k]
    return out


@dataclass(frozen=True)
class PackedSessions:
    """B sessions' chains padded to a shared (B, K) segment layout.

    Row ``b`` describes session ``b``'s current (boundaries, assignment):
    segment k covers ``seg_flops[b, k]`` FLOPs/token and ``seg_wbytes[b, k]``
    parameter bytes on node ``seg_node[b, k]``; ``xfer_bytes_tok[b, k]`` is
    the activation bytes/token entering segment k (0 for k = 0 — the cost
    model does not charge the ingress hop).  ``valid`` masks padding rows and
    ``n_segs[b]`` is the true segment count.
    """

    seg_flops: np.ndarray       # (B, K) float64
    seg_wbytes: np.ndarray      # (B, K) float64
    seg_priv: np.ndarray        # (B, K) bool
    seg_node: np.ndarray        # (B, K) int64 (0-padded)
    valid: np.ndarray           # (B, K) bool
    xfer_bytes_tok: np.ndarray  # (B, K) float64; entry k is the k-1→k boundary
    n_segs: np.ndarray          # (B,) int64
    t_in: np.ndarray            # (B,) float64
    t_out: np.ndarray           # (B,) float64
    lam: np.ndarray             # (B,) float64
    source: np.ndarray          # (B,) int64
    input_bytes_tok: np.ndarray  # (B,) float64 (ingress bytes, migration DP)
    boundaries: tuple[tuple[int, ...], ...]  # per-session, unpadded

    @property
    def batch(self) -> int:
        return int(self.seg_flops.shape[0])

    @property
    def max_segs(self) -> int:
        return int(self.seg_flops.shape[1])

    def with_assignment(self, assignments: Sequence[Sequence[int]]) -> "PackedSessions":
        """Same chains, different placements (candidate evaluation)."""
        seg_node = np.zeros_like(self.seg_node)
        for b, a in enumerate(assignments):
            seg_node[b, : len(a)] = a
        return PackedSessions(
            self.seg_flops, self.seg_wbytes, self.seg_priv, seg_node,
            self.valid, self.xfer_bytes_tok, self.n_segs, self.t_in,
            self.t_out, self.lam, self.source, self.input_bytes_tok,
            self.boundaries,
        )

    def rows(self, idx: Sequence[int]) -> "PackedSessions":
        """Row subset (e.g. the triggered sessions only)."""
        ix = np.asarray(idx, dtype=np.int64)
        return PackedSessions(
            self.seg_flops[ix], self.seg_wbytes[ix], self.seg_priv[ix],
            self.seg_node[ix], self.valid[ix], self.xfer_bytes_tok[ix],
            self.n_segs[ix], self.t_in[ix], self.t_out[ix], self.lam[ix],
            self.source[ix], self.input_bytes_tok[ix],
            tuple(self.boundaries[int(i)] for i in idx),
        )


def pack_sessions(
    items: Sequence[tuple[ModelGraph, Sequence[int], Sequence[int], Workload, int, float]],
    *,
    pad_pow2: bool = True,
    min_k: int = 0,
) -> PackedSessions:
    """Pack (graph, boundaries, assignment, workload, source, input_bytes).

    Segment quantities come from the graphs' prefix sums, so packing is
    O(B·K) array slicing with no cost-model calls.  ``min_k`` floors the
    padded segment axis — callers evaluating a *subset* of a fleet pass the
    fleet's K so every pack in a monitoring cycle shares one compiled shape.
    """
    B = len(items)
    kmax = max(max(len(b) - 1 for _, b, _, _, _, _ in items), min_k)
    K = _pow2(kmax) if pad_pow2 else kmax
    seg_flops = np.zeros((B, K))
    seg_w = np.zeros((B, K))
    seg_priv = np.zeros((B, K), dtype=bool)
    seg_node = np.zeros((B, K), dtype=np.int64)
    valid = np.zeros((B, K), dtype=bool)
    xbytes = np.zeros((B, K))
    n_segs = np.zeros(B, dtype=np.int64)
    t_in = np.zeros(B)
    t_out = np.zeros(B)
    lam = np.zeros(B)
    source = np.zeros(B, dtype=np.int64)
    in_bytes = np.zeros(B)
    bounds: list[tuple[int, ...]] = []
    for i, (g, b, a, wl, src, ibt) in enumerate(items):
        bb = np.asarray(b, dtype=np.int64)
        k = len(bb) - 1
        seg_flops[i, :k] = g._flops_ps[bb[1:]] - g._flops_ps[bb[:-1]]
        seg_w[i, :k] = g._wbytes_ps[bb[1:]] - g._wbytes_ps[bb[:-1]]
        seg_priv[i, :k] = (g._priv_ps[bb[1:]] - g._priv_ps[bb[:-1]]) > 0
        seg_node[i, :k] = a
        valid[i, :k] = True
        # bytes/token crossing each *interior* boundary (entering segment k≥1)
        xbytes[i, 1:k] = [g.boundary_act_bytes(int(x)) for x in bb[1:-1]]
        n_segs[i] = k
        t_in[i], t_out[i] = float(wl.tokens_in), float(wl.tokens_out)
        lam[i] = float(wl.arrival_rate)
        source[i] = int(src)
        in_bytes[i] = float(ibt)
        bounds.append(tuple(int(x) for x in bb))
    return PackedSessions(
        seg_flops, seg_w, seg_priv, seg_node, valid, xbytes, n_segs,
        t_in, t_out, lam, source, in_bytes, tuple(bounds),
    )


def packed_induced_loads(
    packed: PackedSessions, state: SystemState
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every session's induced (node ρ, link ρ, resident bytes) at once.

    Vectorized equivalent of looping :func:`repro_torch.core.fleet.
    session_induced_loads` over the fleet: raw (un-derated) λ·service-time
    scattered onto nodes, boundary traffic scattered onto links, weights onto
    nodes.  Returns ``(node_rho (B, n), link_rho (B, n, n), wbytes (B, n))``.
    """
    B, K = packed.seg_flops.shape
    n = state.num_nodes
    f = state.flops_per_s[packed.seg_node]            # (B, K)
    m = state.mem_bw[packed.seg_node]
    ft = packed.seg_flops / np.maximum(f, _EPS)
    svc = (packed.t_in[:, None] * ft
           + packed.t_out[:, None]
           * np.maximum(ft, packed.seg_wbytes / np.maximum(m, _EPS)))
    svc = np.where(packed.valid, svc, 0.0)
    contrib = packed.lam[:, None] * svc
    rows = np.repeat(np.arange(B), K)
    node_rho = np.zeros((B, n))
    np.add.at(node_rho, (rows, packed.seg_node.ravel()), contrib.ravel())
    wbytes = np.zeros((B, n))
    np.add.at(wbytes, (rows, packed.seg_node.ravel()),
              np.where(packed.valid, packed.seg_wbytes, 0.0).ravel())

    # link loads: boundary k ≥ 1 moves xbytes·total_tokens from node k-1 to k
    prev = np.concatenate(
        [packed.source[:, None], packed.seg_node[:, :-1]], axis=1
    )
    total_tok = packed.t_in + packed.t_out
    bw = state.link_bw[prev, packed.seg_node]         # (B, K)
    cross = (prev != packed.seg_node) & packed.valid & (packed.xfer_bytes_tok > 0)
    lrho = np.where(
        cross,
        packed.lam[:, None] * packed.xfer_bytes_tok * total_tok[:, None]
        / np.maximum(bw, _EPS),
        0.0,
    )
    link_rho = np.zeros((B, n, n))
    np.add.at(
        link_rho,
        (rows, prev.ravel(), packed.seg_node.ravel()),
        lrho.ravel(),
    )
    return node_rho, link_rho, wbytes


# --------------------------------------------------------------------------- #
# batched Φ evaluator
# --------------------------------------------------------------------------- #
def _eval(seg_flops, seg_w, seg_priv, seg_node, valid, xbytes,
          t_in, t_out, lam, bg, link_bw, link_lat, flops_per_s, mem_bw,
          trusted, mem_bytes, *, weights: CostWeights = CostWeights(),
          mem_penalty: float = 1e3, full: bool = False):
    """Batched (B, K)-shaped mirror of chain_latency + evaluate.

    Returns the latency (B,); with ``full`` also the total Φ (B,) and the
    node ρ (B, n).  ``bg`` (B, n) and ``link_bw`` (B, n, n) are per-row
    effective states; the node rates, ``link_lat`` and ``trusted`` are
    shared.  ``mem_bytes`` (B, n) is used by the memory penalty only.
    """
    B, K = seg_flops.shape
    n = bg.shape[1]
    bidx = torch.arange(B, device=seg_flops.device)[:, None]
    derate = torch.clamp_min(1.0 - bg, _EPS)                     # (B, n)
    f_eff = torch.clamp_min(flops_per_s[None, :] * derate, _EPS)
    m_eff = torch.clamp_min(mem_bw[None, :] * derate, _EPS)
    f_seg = torch.gather(f_eff, 1, seg_node)                     # (B, K)
    m_seg = torch.gather(m_eff, 1, seg_node)
    ft = seg_flops / f_seg
    svc = t_in[:, None] * ft + t_out[:, None] * torch.maximum(ft, seg_w / m_seg)
    svc = torch.where(valid, svc, 0.0)

    rho_q = _scatter_rows(seg_node, lam[:, None] * svc, n)
    t_proc = svc.sum(dim=1)
    r = torch.clamp_max(torch.gather(rho_q, 1, seg_node), _RHO_CAP)
    t_queue = (svc * r / (1.0 - r)).sum(dim=1)

    prev = torch.cat([seg_node[:, :1], seg_node[:, :-1]], dim=1)
    has_prev = torch.arange(K, device=seg_node.device)[None, :] > 0
    cross = (prev != seg_node) & valid & has_prev
    bw = link_bw[bidx, prev, seg_node]
    lat = link_lat[prev, seg_node]
    bytes_ = xbytes * (t_in + t_out)[:, None]
    t_tx = torch.where(cross, bytes_ / torch.clamp_min(bw, _EPS) + lat,
                       0.0).sum(dim=1)
    latency = t_proc + t_queue + t_tx
    if not full:
        return latency

    # raw (un-derated) service for the utilization KPI rho
    f_raw = torch.clamp_min(flops_per_s[seg_node], _EPS)
    m_raw = torch.clamp_min(mem_bw[seg_node], _EPS)
    ft_r = seg_flops / f_raw
    svc_raw = t_in[:, None] * ft_r + t_out[:, None] * torch.maximum(
        ft_r, seg_w / m_raw)
    svc_raw = torch.where(valid, svc_raw, 0.0)
    rho = bg + _scatter_rows(seg_node, lam[:, None] * svc_raw, n)
    util = rho.amax(dim=1) + rho.std(dim=1, correction=0)
    tr_seg = trusted[seg_node]
    priv = (valid & seg_priv & ~tr_seg).sum(dim=1).to(latency.dtype)
    used = _scatter_rows(seg_node, torch.where(valid, seg_w, 0.0), n)
    over = torch.clamp_min(used - mem_bytes, 0.0).sum(dim=1)
    total = (weights.alpha * latency + weights.beta * util
             + weights.gamma * priv + mem_penalty * over / 1e9)
    return latency, total, rho


def _pad_rows(a: np.ndarray, Bp: int) -> np.ndarray:
    """pow2 batch padding: repeat the last row up to ``Bp`` rows."""
    B = a.shape[0]
    if Bp == B:
        return a
    return np.concatenate([a, np.repeat(a[-1:], Bp - B, axis=0)], axis=0)


class _OnDevice:
    """The shared ``device`` / host-to-device plumbing of the fleet parts."""

    def __init__(self, *, device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)

    def t(self, a, dtype=_F64) -> torch.Tensor:
        """Host array → tensor on this device (float64 unless told)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def state_tail(self, state: SystemState):
        """(link_lat, flops_per_s, mem_bw, trusted) of ``state`` on device."""
        return (self.t(np.nan_to_num(state.link_lat, posinf=_BIG)),
                self.t(state.flops_per_s), self.t(state.mem_bw),
                self.t(state.trusted.astype(bool), torch.bool))


class FleetCostEvaluator(_OnDevice):
    """One call prices every session against its own effective C(t).

    ``evaluate_batch`` mirrors :func:`repro_torch.core.cost_model.
    chain_latency` (Eq. 10: T_proc + T_queue + T_tx) and the scalar
    :func:`~repro_torch.core.cost_model.evaluate` (Φ + soft memory penalty)
    in float64 on ``device``, so results match the numpy reference to
    rounding error.  B arrives power-of-two padded.

    ``cost_model`` selects the pricing provider; measured calibration enters
    through :meth:`pack` (a calibrated-graph view of each packed item).
    """

    def __init__(self, cost_model: CostModel | None = None, *,
                 device: str | torch.device = "cuda") -> None:
        super().__init__(device=device)
        self.cost_model = cost_model if cost_model is not None \
            else AnalyticCostModel()

    def pack(
        self,
        items: Sequence[tuple[ModelGraph, Sequence[int], Sequence[int],
                              Workload, int, float]],
        *,
        min_k: int = 0,
    ) -> PackedSessions:
        """:func:`pack_sessions` through this evaluator's cost model."""
        cal = self.cost_model.calibrated
        return pack_sessions(
            [(cal(g), b, a, wl, src, ib) for g, b, a, wl, src, ib in items],
            min_k=min_k,
        )

    def evaluate_batch(
        self,
        packed: PackedSessions,
        *,
        bg: np.ndarray,                 # (B, n) per-session background util
        link_bw: np.ndarray,            # (B, n, n) per-session link bandwidth
        mem_bytes: np.ndarray,          # (B, n) per-session residual memory
        state: SystemState,             # shared capacities / latencies / trust
        weights: CostWeights = CostWeights(),
        mem_penalty: float = 1e3,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (latency (B,), total Φ (B,), node ρ (B, n))."""
        B = packed.batch
        # pad the batch axis to the next power of two (the reference's
        # layout: the triggered-subset size varies cycle to cycle)
        Bp = _pow2(B)

        def pad(a, dtype=_F64):
            return self.t(_pad_rows(np.asarray(a), Bp), dtype)

        # the cost model treats an infinite (local) link as free; keep the
        # tensors finite and let the same-node mask zero those hops
        finite_bw = np.nan_to_num(link_bw, posinf=_BIG)
        link_lat, flops_per_s, mem_bw, trusted = self.state_tail(state)
        lat, total, rho = _eval(
            pad(packed.seg_flops), pad(packed.seg_wbytes),
            pad(packed.seg_priv, torch.bool), pad(packed.seg_node, torch.int64),
            pad(packed.valid, torch.bool), pad(packed.xfer_bytes_tok),
            pad(packed.t_in), pad(packed.t_out), pad(packed.lam), pad(bg),
            pad(finite_bw), link_lat, flops_per_s, mem_bw, trusted,
            pad(mem_bytes), weights=weights, mem_penalty=mem_penalty,
            full=True,
        )
        lat, total, rho = to_host(lat[:B], total[:B], rho[:B])
        return lat, total, rho


# --------------------------------------------------------------------------- #
# batched migration DP (Eq. 7 over the triggered set)
# --------------------------------------------------------------------------- #
def _surrogate_inputs(
    packed: PackedSessions,
    *,
    bg: np.ndarray,
    link_bw: np.ndarray,
    state: SystemState,
    mem: np.ndarray | None = None,
):
    """Additive Eq. 7 surrogate tensors for B sessions (host-side numpy).

    Returns ``(exec_cost (B, K, n), xfer (B, K, n, n), src_xfer (B, n))``:
    per-segment M/M/1-inflated derated service with privacy +``_BIG`` masks,
    per-boundary transfer matrices, and the ingress transfer row.  ``mem``
    (B, n) adds the Eq. 4 single-segment mask — a node whose residual memory
    cannot hold a segment's weights alone is +``_BIG`` for that segment,
    masked exactly like a privacy breach (multi-segment accumulation on one
    node is outside the DP state; the repair pass handles it).

    This is the pinned host reference: the hot paths
    (:class:`BatchedMigrationSolver`, :class:`BatchedRepairPass`, the fused
    migrate) expand the same tensors on the device from the (B, K)
    ``xfer_bytes_tok`` vector via :func:`_surrogate_batch`; the device
    expansion is held against this function in the tests.
    """
    B, K = packed.seg_flops.shape
    n = state.num_nodes
    derate = np.maximum(_EPS, 1.0 - bg)                      # (B, n)
    f_eff = np.maximum(state.flops_per_s[None, :] * derate, _EPS)
    m_eff = np.maximum(state.mem_bw[None, :] * derate, _EPS)
    ft = packed.seg_flops[:, :, None] / f_eff[:, None, :]    # (B, K, n)
    svc = (packed.t_in[:, None, None] * ft
           + packed.t_out[:, None, None]
           * np.maximum(ft, packed.seg_wbytes[:, :, None] / m_eff[:, None, :]))
    load = np.minimum(packed.lam[:, None, None] * svc, 0.9)
    exec_cost = svc / (1.0 - load)
    untrusted = ~state.trusted.astype(bool)
    exec_cost = np.where(
        packed.seg_priv[:, :, None] & untrusted[None, None, :],
        _BIG, exec_cost,
    )
    if mem is not None:
        exec_cost = np.where(
            packed.seg_wbytes[:, :, None] > mem[:, None, :], _BIG, exec_cost
        )

    total_tok = (packed.t_in + packed.t_out)[:, None, None, None]
    bw = np.nan_to_num(link_bw, posinf=_BIG)                 # (B, n, n)
    lat = np.nan_to_num(state.link_lat, posinf=_BIG)
    xfer = (packed.xfer_bytes_tok[:, :, None, None] * total_tok
            / np.maximum(bw[:, None], _EPS)) + lat[None, None]
    diag = np.eye(n, dtype=bool)
    xfer[:, :, diag] = 0.0

    src_bytes = packed.input_bytes_tok * (packed.t_in + packed.t_out)
    src_xfer = (src_bytes[:, None]
                / np.maximum(bw[np.arange(B), packed.source], _EPS)
                + lat[packed.source])
    same = packed.source[:, None] == np.arange(n)[None, :]
    src_xfer = np.where(same, 0.0, src_xfer)
    return exec_cost, xfer, src_xfer


def _surrogate_batch(seg_flops, seg_w, seg_priv, xbytes, t_in, t_out, lam,
                     source, input_bytes_tok, bg, lbw, link_lat, flops_per_s,
                     mem_bw, trusted, mem):
    """Device expansion of the Eq. 7 surrogate tensors from the row layout.

    Tensor mirror of :func:`_surrogate_inputs` (the pinned host reference):
    the (B, K, n, n) transfer tensor and (B, K, n) exec-cost tensor are
    expanded on the device from the (B, K) boundary-bytes vector and the
    per-row effective link matrix.  ``mem=None`` omits the Eq. 4
    single-segment mask.  Callers pass ``lbw`` / ``link_lat`` already
    ``nan_to_num``-finited, exactly like the host path.
    """
    B = seg_flops.shape[0]
    n = bg.shape[1]
    dev = seg_flops.device
    derate = torch.clamp_min(1.0 - bg, _EPS)                      # (B, n)
    f_eff = torch.clamp_min(flops_per_s[None, :] * derate, _EPS)
    m_eff = torch.clamp_min(mem_bw[None, :] * derate, _EPS)
    ft = seg_flops[:, :, None] / f_eff[:, None, :]                # (B, K, n)
    svc = (t_in[:, None, None] * ft
           + t_out[:, None, None]
           * torch.maximum(ft, seg_w[:, :, None] / m_eff[:, None, :]))
    load = torch.clamp_max(lam[:, None, None] * svc, 0.9)
    exec_cost = svc / (1.0 - load)
    exec_cost = torch.where(
        seg_priv[:, :, None] & (~trusted)[None, None, :], _BIG, exec_cost)
    if mem is not None:
        # Eq. 4 per-step mask: a segment that alone overflows a node's
        # residual memory loses that node inside the DP, not at commit time
        exec_cost = torch.where(
            seg_w[:, :, None] > mem[:, None, :], _BIG, exec_cost)
    total_tok = (t_in + t_out)[:, None, None, None]
    xfer = (xbytes[:, :, None, None] * total_tok
            / torch.clamp_min(lbw[:, None], _EPS)) + link_lat[None, None]
    xfer = torch.where(torch.eye(n, dtype=torch.bool, device=dev), 0.0, xfer)
    src_bytes = input_bytes_tok * (t_in + t_out)
    rows = torch.arange(B, device=dev)
    src_xfer = (src_bytes[:, None]
                / torch.clamp_min(lbw[rows, source], _EPS)
                + link_lat[source])
    src_xfer = torch.where(
        source[:, None] == torch.arange(n, device=dev)[None, :], 0.0, src_xfer)
    return exec_cost, xfer, src_xfer


def _migration_dp(exec_cost, xfer, n_segs, src_xfer):
    """Masked placement DP over B rows: (C (B, n), parents (B, K-1, n)).

    ``exec_cost`` (B, K, n) per-segment cost on each node (+``_BIG`` on a
    privacy breach), ``xfer`` (B, K, n, n) boundary-k transfer matrices,
    ``src_xfer`` (B, n) the ingress row for segment 0.  Steps past a row's
    ``n_segs`` keep its carry and write identity parents.
    """
    B, K, n = exec_cost.shape
    ar = torch.arange(n, device=exec_cost.device)
    C = exec_cost[:, 0] + src_xfer
    parents = []
    for j in range(1, K):
        active = (j < n_segs)[:, None]
        cand = C[:, :, None] + xfer[:, j] + exec_cost[:, j][:, None, :]
        best_prev = torch.argmin(cand, dim=1)                      # (B, n)
        new_c = torch.gather(cand, 1, best_prev[:, None, :])[:, 0]
        C = torch.where(active, new_c, C)
        parents.append(torch.where(active, best_prev, ar))
    if not parents:
        return C, exec_cost.new_zeros((B, 0, n), dtype=torch.int64)
    return C, torch.stack(parents, dim=1)


def _backtrack_rows(C, parents, n_segs):
    """Device backtrack of :func:`_migration_dp`: assignments (B, K).

    Rows shorter than K hold the carry until the DP enters their chain, so
    position k-1 lands the argmin row-end; padded positions repeat it.
    """
    B, n = C.shape
    K = parents.shape[1] + 1
    rows = torch.arange(B, device=C.device)
    j0 = torch.argmin(C, dim=1)
    j = j0
    ys: list = [None] * (K - 1)
    for step in range(K - 2, -1, -1):
        j = torch.where(step <= n_segs - 2, parents[rows, step, j], j)
        ys[step] = j
    return torch.stack(ys + [j0], dim=1)


class BatchedMigrationSolver(_OnDevice):
    """All triggered sessions' placement migrations in ONE device pass.

    Same additive surrogate as :func:`repro_torch.core.placement.
    solve_placement_chain_dp` (per-segment M/M/1-inflated service + boundary
    transfers, privacy as +``_BIG`` masks), with per-session effective states:
    each row carries its own background-utilization vector and link matrix.
    Chains shorter than the padded K are masked with identity DP steps, so
    mixed segment counts share one pass.
    """

    def solve_batch(
        self,
        packed: PackedSessions,
        *,
        bg: np.ndarray,
        link_bw: np.ndarray,
        state: SystemState,
        mem: np.ndarray | None = None,
    ) -> list[Solution]:
        """``mem`` (B, n) residual memory enables the Eq. 4 per-step mask
        (see :func:`_surrogate_inputs`); ``None`` keeps the memory-blind
        surrogate, bit-compatible with the scalar reference DP."""
        B = packed.batch
        Bp = _pow2(B)

        def rep(a, dtype=_F64):
            return self.t(_pad_rows(np.asarray(a), Bp), dtype)

        link_lat, flops_per_s, mem_bw, trusted = self.state_tail(state)
        exec_cost, xfer, src_xfer = _surrogate_batch(
            rep(packed.seg_flops), rep(packed.seg_wbytes),
            rep(packed.seg_priv, torch.bool), rep(packed.xfer_bytes_tok),
            rep(packed.t_in), rep(packed.t_out), rep(packed.lam),
            rep(packed.source, torch.int64), rep(packed.input_bytes_tok),
            rep(np.asarray(bg, dtype=np.float64)),
            rep(np.nan_to_num(link_bw, posinf=_BIG)), link_lat, flops_per_s,
            mem_bw, trusted,
            None if mem is None else rep(np.asarray(mem, dtype=np.float64)),
        )
        C, parents = _migration_dp(exec_cost, xfer,
                                   rep(packed.n_segs, torch.int64), src_xfer)
        C, parents = to_host(C[:B], parents[:B])

        out: list[Solution] = []
        for b in range(B):
            k = int(packed.n_segs[b])
            j = int(np.argmin(C[b]))
            assign = [j]
            for step in range(k - 2, -1, -1):
                j = int(parents[b, step, j])
                assign.append(j)
            assign.reverse()
            out.append(
                Solution(packed.boundaries[b], tuple(assign), float(C[b].min()))
            )
        return out


# --------------------------------------------------------------------------- #
# batched Eq. 4 repair (greedy heaviest-segment moves)
# --------------------------------------------------------------------------- #
def _repair(seg_w, valid, n_segs, assign, mem, exec_cost, xfer, src_xfer):
    """Greedy memory repair of B rows at once: repaired assignments (B, K).

    Device mirror of :func:`repro_torch.core.placement.repair_capacity`'s
    feasibility loop: each iteration moves the heaviest *movable* segment
    off the most overfull node to the cheapest destination that fits
    (movable = some destination has room for it).  A move never creates a
    new violation — the fit check admits only in-capacity destinations — so
    every segment relocates at most once and K iterations suffice; a row
    with no violation is an exact no-op, and a stuck row (nothing movable
    off the worst node) stays put, same as the scalar ``break``.

    Destination choice prices the additive surrogate (exec + the two
    adjacent boundary transfers) instead of the scalar path's full Φ, so
    the chosen node may differ; feasibility restoration is what must match.
    Privacy enters through the +``_BIG`` exec mask: a breaching destination
    is taken only when nothing else fits.
    """
    B, K = seg_w.shape
    n = mem.shape[1]
    dev = seg_w.device
    idx = torch.arange(n, device=dev)
    rows = torch.arange(B, device=dev)
    wv = torch.where(valid, seg_w, 0.0)
    a = assign
    for _ in range(K):
        used = _scatter_rows(a, wv, n)                             # (B, n)
        over = torch.clamp_min(used - mem, 0.0)
        bad = torch.argmax(over, dim=1)                            # (B,)
        has_over = over[rows, bad] > 0.0
        fits = ((used[:, None, :] + seg_w[:, :, None] <= mem[:, None, :])
                & (idx[None, None, :] != bad[:, None, None]))      # (B, K, n)
        movable = valid & (a == bad[:, None]) & fits.any(dim=2)
        k_star = torch.argmax(torch.where(movable, seg_w, -1.0), dim=1)
        can_move = has_over & movable.any(dim=1)
        prev = a[rows, torch.clamp_min(k_star - 1, 0)]
        in_c = torch.where((k_star == 0)[:, None], src_xfer,
                           xfer[rows, k_star, prev])
        nxt_k = torch.clamp_max(k_star + 1, K - 1)
        out_c = torch.where((k_star + 1 < n_segs)[:, None],
                            xfer[rows, nxt_k, :, a[rows, nxt_k]], 0.0)
        cost = exec_cost[rows, k_star] + in_c + out_c
        dest = torch.argmin(torch.where(fits[rows, k_star], cost, torch.inf),
                            dim=1)
        moved = a.clone()
        moved[rows, k_star] = dest
        a = torch.where(can_move[:, None], moved, a)
    return a


class BatchedRepairPass(_OnDevice):
    """All violating sessions' Eq. 4 repairs in ONE device pass.

    The greedy heaviest-segment moves for B sessions run as one batched
    program, pow2-padded on B like the other batched solvers.  Rows already
    feasible come back bit-unchanged.  :meth:`repair_and_price_batch`
    additionally prices the repaired assignments (the batched Φ mirror) in
    the same call.  The scalar :func:`repro_torch.core.placement.
    repair_capacity` remains the pinned reference path.
    """

    def __init__(self, *, device: str | torch.device = "cuda") -> None:
        super().__init__(device=device)
        self.dispatches = 0

    def _run(self, packed: PackedSessions, bg, link_bw, mem, state,
             price: bool, weights: CostWeights, mem_penalty: float):
        self.dispatches += 1
        B = packed.batch
        Bp = _pow2(B)

        def rep(a, dtype=_F64):
            return self.t(_pad_rows(np.asarray(a), Bp), dtype)

        seg_flops, seg_w = rep(packed.seg_flops), rep(packed.seg_wbytes)
        seg_priv, valid = (rep(packed.seg_priv, torch.bool),
                           rep(packed.valid, torch.bool))
        seg_node, n_segs = (rep(packed.seg_node, torch.int64),
                            rep(packed.n_segs, torch.int64))
        xbytes = rep(packed.xfer_bytes_tok)
        t_in, t_out, lam = rep(packed.t_in), rep(packed.t_out), rep(packed.lam)
        bg_t = rep(np.asarray(bg, dtype=np.float64))
        lbw = rep(np.nan_to_num(link_bw, posinf=_BIG))
        mem_t = rep(np.asarray(mem, dtype=np.float64))
        link_lat, flops_per_s, mem_bw, trusted = self.state_tail(state)
        # the destination-cost surrogate is memory-UNmasked (the fit check,
        # not the price, enforces capacity)
        exec_cost, xfer, src_xfer = _surrogate_batch(
            seg_flops, seg_w, seg_priv, xbytes, t_in, t_out, lam,
            rep(packed.source, torch.int64), rep(packed.input_bytes_tok),
            bg_t, lbw, link_lat, flops_per_s, mem_bw, trusted, None,
        )
        assign = _repair(seg_w, valid, n_segs, seg_node, mem_t, exec_cost,
                         xfer, src_xfer)
        if not price:
            return to_host(assign[:B])[0]
        lat = _eval(seg_flops, seg_w, seg_priv, assign, valid, xbytes, t_in,
                    t_out, lam, bg_t, lbw, link_lat, flops_per_s, mem_bw,
                    trusted, mem_t, weights=weights, mem_penalty=mem_penalty)
        return to_host(assign[:B], lat[:B])

    def repair_batch(
        self,
        packed: PackedSessions,
        *,
        bg: np.ndarray,
        link_bw: np.ndarray,
        mem: np.ndarray,
        state: SystemState,
    ) -> np.ndarray:
        """Repaired assignments (B, K) for the packed rows' current
        ``seg_node`` against per-row residual memory ``mem`` (B, n)."""
        return self._run(packed, bg, link_bw, mem, state, False,
                         CostWeights(), 1e3)

    def repair_and_price_batch(
        self,
        packed: PackedSessions,
        *,
        bg: np.ndarray,
        link_bw: np.ndarray,
        mem: np.ndarray,
        state: SystemState,
        weights: CostWeights = CostWeights(),
        mem_penalty: float = 1e3,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(repaired assignments (B, K), latency (B,) of the repaired
        assignment) in one call — the batched Φ mirror prices exactly what
        :class:`FleetCostEvaluator` would."""
        return self._run(packed, bg, link_bw, mem, state, True, weights,
                         mem_penalty)


# --------------------------------------------------------------------------- #
# device-resident incremental fleet state
# --------------------------------------------------------------------------- #
# buffer attrs deliberately share PackedSessions' field names, so rows copy
# between the two layouts by getattr on the same name
_ROW_FIELDS = ("seg_flops", "seg_wbytes", "seg_priv", "seg_node", "valid",
               "xfer_bytes_tok")
_VEC_FIELDS = ("n_segs", "t_in", "t_out", "lam", "source", "input_bytes_tok")
_DTYPES = {"seg_priv": torch.bool, "valid": torch.bool, "active": torch.bool,
           "seg_node": torch.int64, "n_segs": torch.int64,
           "source": torch.int64}


class FleetStateBuffers:
    """Persistent device-resident (B, K) fleet tensors, updated row-wise.

    Row ``b`` holds one live session in the :class:`PackedSessions` layout
    (``active[b]`` masks free rows).  The row axis grows by amortized
    doubling and the segment axis by powers of two — the reference's padded
    layout.  Rows are written in place; a departure-then-admit reuses the
    freed slot, so steady-state churn never reallocates.

    Invariant (test-enforced): an inactive row is all-zeros, and every
    active row is bit-identical to what a cold :func:`pack_sessions` repack
    of the same session would produce — :meth:`upsert` builds the row
    through :func:`pack_sessions` itself.
    """

    def __init__(self, *, rows: int = 8, segs: int = 4,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        rows = _pow2(max(1, rows))
        segs = _pow2(max(1, segs))
        for name in _ROW_FIELDS:
            setattr(self, name, torch.zeros(
                (rows, segs), dtype=_DTYPES.get(name, _F64),
                device=self.device))
        for name in (*_VEC_FIELDS, "active"):
            setattr(self, name, torch.zeros(
                rows, dtype=_DTYPES.get(name, _F64), device=self.device))
        self.row_of: dict[int, int] = {}
        self._free: list[int] = list(range(rows - 1, -1, -1))
        self._boundaries: list[tuple[int, ...] | None] = [None] * rows
        self.stats = {"row_writes": 0, "rebuilds": 0, "grow_rows": 0,
                      "grow_segs": 0, "pack_time_s": 0.0}
        # globally-unique mutation stamp: every write assigns a fresh value
        # from one process-wide counter, so (even across buffer objects that
        # reuse a freed id) equal stamps imply bit-identical row tensors —
        # the sharded screen keys its stacked-block cache on it
        self.version = next(_BUF_VERSIONS)

    # -- capacity ------------------------------------------------------- #
    @property
    def n_rows(self) -> int:
        return int(self.seg_flops.shape[0])

    @property
    def max_segs(self) -> int:
        return int(self.seg_flops.shape[1])

    def __len__(self) -> int:
        return len(self.row_of)

    def _grow_rows(self, need: int) -> None:
        old = self.n_rows
        new = _pow2(max(need, 2 * old))
        for name in (*_ROW_FIELDS, *_VEC_FIELDS, "active"):
            a = getattr(self, name)
            pad = a.new_zeros((new - old, *a.shape[1:]))
            setattr(self, name, torch.cat([a, pad], dim=0))
        self._free.extend(range(new - 1, old - 1, -1))
        self._boundaries.extend([None] * (new - old))
        self.stats["grow_rows"] += 1
        self.version = next(_BUF_VERSIONS)

    def _grow_segs(self, need: int) -> None:
        old = self.max_segs
        new = _pow2(need)
        if new <= old:
            return
        for name in _ROW_FIELDS:
            a = getattr(self, name)
            pad = a.new_zeros((a.shape[0], new - old))
            setattr(self, name, torch.cat([a, pad], dim=1))
        self.stats["grow_segs"] += 1
        self.version = next(_BUF_VERSIONS)

    def _write(self, rows, packed: PackedSessions) -> None:
        """Copy ``packed``'s rows into buffer rows ``rows`` (one upload)."""
        names = (*_ROW_FIELDS, *_VEC_FIELDS)
        host = np.concatenate(
            [np.asarray(getattr(packed, nm), dtype=np.float64)
             .reshape(packed.batch, -1) for nm in names], axis=1)
        dev = torch.as_tensor(host, device=self.device)
        off = 0
        for nm in names:
            a = getattr(self, nm)
            w = 1 if a.dim() == 1 else a.shape[1]
            a[rows] = dev[:, off:off + w].reshape(
                (-1, *a.shape[1:])).to(a.dtype)
            off += w
        self.active[rows] = True
        self.version = next(_BUF_VERSIONS)

    # -- row updates ---------------------------------------------------- #
    def upsert(
        self,
        sid: int,
        graph: ModelGraph,
        boundaries: Sequence[int],
        assignment: Sequence[int],
        workload: Workload,
        source_node: int,
        input_bytes_per_token: float,
    ) -> None:
        """Write one session's current config into its row (allocating one)."""
        t0 = time.perf_counter()
        self._grow_segs(len(boundaries) - 1)
        row = self.row_of.get(sid)
        if row is None:
            if not self._free:
                self._grow_rows(self.n_rows + 1)
            row = self._free.pop()
            self.row_of[sid] = row
        one = pack_sessions(
            [(graph, tuple(boundaries), tuple(assignment), workload,
              source_node, input_bytes_per_token)],
            pad_pow2=False, min_k=self.max_segs,
        )
        self._write(slice(row, row + 1), one)
        self._boundaries[row] = one.boundaries[0]
        self.stats["row_writes"] += 1
        self.stats["pack_time_s"] += time.perf_counter() - t0

    def remove(self, sid: int) -> None:
        """Free a departed session's row (zeroed: inactive rows stay zeros)."""
        row = self.row_of.pop(sid)
        for name in (*_ROW_FIELDS, *_VEC_FIELDS, "active"):
            getattr(self, name)[row] = 0
        self._boundaries[row] = None
        self._free.append(row)
        self.version = next(_BUF_VERSIONS)

    @classmethod
    def from_sessions(
        cls,
        items: Sequence[tuple[int, tuple]],
        *,
        min_rows: int = 8,
        min_segs: int = 4,
        device: str | torch.device = "cuda",
        layout: dict | None = None,
    ) -> "FleetStateBuffers":
        """Cold full repack: ``items`` is [(sid, pack_sessions item), ...].

        Rows land densely in ``items`` order and are bit-identical to a
        :func:`pack_sessions` call over the same items — this IS the
        reference the incremental path is equivalence-tested against.
        ``layout`` (a :meth:`layout` of buffers holding the same sessions)
        puts every row where those buffers had it instead, with their
        free-row stack and segment width.
        """
        t0 = time.perf_counter()
        n = len(items)
        if layout is None:
            row_of = {sid: i for i, (sid, _) in enumerate(items)}
            rows, segs = max(min_rows, n), min_segs
        else:
            row_of = {int(sid): r for r, sid in enumerate(layout["row_sid"])
                      if sid >= 0}
            if set(row_of) != {sid for sid, _ in items}:
                raise ValueError("layout holds other sessions than items")
            rows = len(layout["row_sid"])
            segs = max(min_segs, int(layout["max_segs"]))
        if n == 0:
            buf = cls(rows=rows, segs=segs, device=device)
        else:
            packed = pack_sessions([it for _, it in items], pad_pow2=True,
                                   min_k=segs)
            buf = cls(rows=rows, segs=packed.max_segs, device=device)
            where = [row_of[sid] for sid, _ in items]
            buf._write(where, packed)
            buf.row_of = {sid: row_of[sid] for sid, _ in items}
            buf._free = list(range(buf.n_rows - 1, n - 1, -1))
            for r, b in zip(where, packed.boundaries):
                buf._boundaries[r] = b
        if layout is not None:
            buf._free = [int(r) for r in layout["free"]]
        buf.stats["rebuilds"] += 1
        buf.stats["pack_time_s"] += time.perf_counter() - t0
        return buf

    def layout(self) -> dict[str, np.ndarray]:
        """Where each session's row lies, as host integers: the session of
        every row (-1: free), the free-row stack and the segment width.

        The fixed point colours rows by index parity and the fleet totals
        reduce over rows in row order, so a rebuild that has to continue
        bit-identically (a journal restore after churn) needs the placement
        as well as the rows' contents.
        """
        row_sid = np.full(self.n_rows, -1, dtype=np.int64)
        for sid, r in self.row_of.items():
            row_sid[r] = sid
        return {"row_sid": row_sid,
                "free": np.asarray(self._free, dtype=np.int64),
                "max_segs": np.asarray(self.max_segs, dtype=np.int64)}

    # -- host views ----------------------------------------------------- #
    def rows_packed(self, sids: Sequence[int]) -> PackedSessions:
        """Host :class:`PackedSessions` view of the given sessions' rows."""
        rows = [self.row_of[s] for s in sids]
        fields = gather_rows(
            rows, *(getattr(self, name) for name in (*_ROW_FIELDS, *_VEC_FIELDS))
        )
        return PackedSessions(
            *fields,
            boundaries=tuple(self._boundaries[r] for r in rows),
        )


# --------------------------------------------------------------------------- #
# fused monitoring-step programs over the resident buffers
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ResidentPrice:
    """Device-side outputs of one fused pricing call (row-indexed).

    Only ``lat`` / ``max_util`` / ``min_bw`` — O(B) scalars — are meant to
    be pulled to host every cycle; the effective-state tensors stay on
    device and are row-gathered only for the triggered set.

    The ``*_fc`` fields are populated only when a
    :class:`~repro_torch.core.forecast.CapacityForecaster` rode the call:
    the same quantities priced against the worst-case forecast capacity
    over the horizon (current values until one season has been observed,
    and bit-identically the current values at ``horizon_steps = 0``).
    """

    lat: torch.Tensor        # (B,)   current-config latency per row
    max_util: torch.Tensor   # (B,)   max node util over the nodes the row touches
    min_bw: torch.Tensor     # (B,)   min effective bw over the row's cross hops
    bg: torch.Tensor         # (B, n) effective background util (others folded in)
    link_bw: torch.Tensor    # (B, n, n) effective link bandwidth
    mem: torch.Tensor        # (B, n) residual memory
    tot_node: torch.Tensor   # (n,)   fleet-total induced node rho
    tot_link: torch.Tensor   # (n, n) fleet-total link rho
    tot_w: torch.Tensor      # (n,)   fleet-total resident weight bytes
    lat_fc: torch.Tensor | None = None       # (B,) latency under worst-case C
    max_util_fc: torch.Tensor | None = None  # (B,) forecast env max node util
    min_bw_fc: torch.Tensor | None = None    # (B,) forecast env min link bw
    bg_fc: torch.Tensor | None = None        # (B, n) forecast effective bg util
    lbw_fc: torch.Tensor | None = None       # (B, n, n) forecast effective bw

    @property
    def has_forecast(self) -> bool:
        return self.lat_fc is not None


def _induced(a, seg_flops, seg_w, valid, xbytes, t_in, t_out, lam, source,
             active, link_bw, flops_per_s, mem_bw):
    """Induced loads of joint assignment ``a``: raw (un-derated) λ·service
    onto nodes, boundary traffic onto links, resident weights onto nodes.

    Returns ``(node_r (B, n), link_r (B, n, n), wb (B, n), prev (B, K))``;
    inactive rows and padded segments contribute zeros.
    """
    n = flops_per_s.shape[0]
    av = valid & active[:, None]
    f_raw = torch.clamp_min(flops_per_s[a], _EPS)
    m_raw = torch.clamp_min(mem_bw[a], _EPS)
    ft = seg_flops / f_raw
    svc = t_in[:, None] * ft + t_out[:, None] * torch.maximum(ft, seg_w / m_raw)
    svc = torch.where(av, svc, 0.0)
    node_r = _scatter_rows(a, lam[:, None] * svc, n)
    wb = _scatter_rows(a, torch.where(av, seg_w, 0.0), n)
    prev = torch.cat([source[:, None], a[:, :-1]], dim=1)
    total_tok = t_in + t_out
    cross = (prev != a) & av & (xbytes > 0)
    lrho = torch.where(
        cross,
        lam[:, None] * xbytes * total_tok[:, None]
        / torch.clamp_min(link_bw[prev, a], _EPS),
        0.0,
    )
    link_r = _scatter_links(prev, a, lrho, n)
    return node_r, link_r, wb, prev


def _fold(node_r, link_r, wb, base_bg, base_lbw, mem_bytes, bw_floor):
    """Per-row effective C(t), everyone else folded in as load — the
    ``FleetOrchestrator._fold_loads`` formula over (B, ·) batches.

    Returns ``(bg, lbw, mem, tot_node, tot_link, tot_w)``.
    """
    tot_node = node_r.sum(dim=0)
    tot_link = link_r.sum(dim=0)
    tot_w = wb.sum(dim=0)
    bg = torch.clamp(base_bg[None, :] + (tot_node[None, :] - node_r),
                     0.0, 0.99)
    lbw = base_lbw[None] * torch.clamp(1.0 - (tot_link[None] - link_r),
                                       bw_floor, 1.0)
    mem = torch.clamp_min(mem_bytes[None, :] - (tot_w[None, :] - wb), 0.0)
    return bg, lbw, mem, tot_node, tot_link, tot_w


def _trigger_env(util_base, tot_node, tot_link, link_bw, seg_node, valid,
                 source, prev, bw_floor):
    """Per-row trigger env (``_session_env``): the fleet-level util vector
    and effective link matrix, reduced over the nodes/links THIS row
    touches.  Returns ``(max_util (B,), min_bw (B,))``."""
    util_vec = torch.clamp(util_base + tot_node, 0.0, 2.0)
    u_seg = torch.where(valid, util_vec[seg_node], -torch.inf)
    max_util = torch.maximum(u_seg.amax(dim=1), util_vec[source])
    ebw = link_bw * torch.clamp(1.0 - tot_link, bw_floor, 1.0)
    hop_ok = valid & (prev != seg_node)
    min_bw = torch.where(hop_ok, ebw[prev, seg_node], torch.inf).amin(dim=1)
    return max_util, min_bw


def _price(seg_flops, seg_w, seg_priv, seg_node, valid, xbytes,
           t_in, t_out, lam, source, active,
           bg0, link_bw, link_lat, flops_per_s, mem_bw, trusted, mem_bytes,
           *, weights: CostWeights, mem_penalty: float, bw_floor: float,
           forecast=None):
    """The fused pricing program: induced loads → effective C(t) → batched
    Φ → trigger env, and — with ``forecast`` — the seasonal ring update,
    the worst-case capacity over the horizon and the same quantities
    re-priced against it.

    ``forecast`` is ``(util_ring, bw_ring, resid_u, resid_b, idx, count,
    advance, horizon, resid_alpha)``.  Returns the :class:`ResidentPrice`
    fields, plus ``(bg_wc, bw_wc, util_ring', bw_ring', resid_u',
    resid_b')`` with a forecast.  With ``horizon == 0`` the forecast outputs
    ARE the current outputs, making the reactive A/B bit-identical.
    """
    ev = dict(weights=weights, mem_penalty=mem_penalty)
    node_r, link_r, wb, prev = _induced(
        seg_node, seg_flops, seg_w, valid, xbytes, t_in, t_out, lam, source,
        active, link_bw, flops_per_s, mem_bw)
    bg, lbw, mem, tot_node, tot_link, tot_w = _fold(
        node_r, link_r, wb, bg0, link_bw, mem_bytes, bw_floor)
    lat = _eval(seg_flops, seg_w, seg_priv, seg_node, valid, xbytes, t_in,
                t_out, lam, bg, lbw, link_lat, flops_per_s, mem_bw, trusted,
                mem, **ev)
    max_util, min_bw = _trigger_env(bg0, tot_node, tot_link, link_bw,
                                    seg_node, valid, source, prev, bw_floor)
    out = (lat, max_util, min_bw, bg, lbw, mem, tot_node, tot_link, tot_w)
    if forecast is None:
        return out
    (util_ring, bw_ring, resid_u, resid_b, idx, count, advance, horizon,
     resid_alpha) = forecast
    # ring/residual update (cadence-gated by `advance`)
    util_ring2, resid_u2 = seasonal_update(
        util_ring, resid_u, idx, count, bg0, advance, resid_alpha)
    bw_ring2, resid_b2 = seasonal_update(
        bw_ring, resid_b, idx, count, link_bw, advance, resid_alpha)
    bg_wc, bw_wc = worst_case_capacity(
        util_ring2, resid_u2, bw_ring2, resid_b2, idx,
        count + (1 if advance else 0), bg0, link_bw, horizon)
    if horizon == 0:
        fc = (lat, max_util, min_bw, bg, lbw)
    else:
        # per-row fold of the worst-case base capacity (_fold_loads with
        # bg_wc/bw_wc in place of the instantaneous C(t))
        bg_fc = torch.clamp(bg_wc[None, :] + (tot_node[None, :] - node_r),
                            0.0, 0.99)
        lbw_fc = bw_wc[None] * torch.clamp(1.0 - (tot_link[None] - link_r),
                                           bw_floor, 1.0)
        lat_fc = _eval(seg_flops, seg_w, seg_priv, seg_node, valid, xbytes,
                       t_in, t_out, lam, bg_fc, lbw_fc, link_lat, flops_per_s,
                       mem_bw, trusted, mem, **ev)
        util_fc, bw_fc = _trigger_env(bg_wc, tot_node, tot_link, bw_wc,
                                      seg_node, valid, source, prev, bw_floor)
        fc = (lat_fc, util_fc, bw_fc, bg_fc, lbw_fc)
    return (*out, *fc, bg_wc, bw_wc, util_ring2, bw_ring2, resid_u2, resid_b2)


def _migrate_rows(seg_flops, seg_w, seg_priv, valid, xbytes, n_segs, t_in,
                  t_out, lam, source, input_bytes_tok, bg, lbw, mem,
                  link_lat, flops_per_s, mem_bw, trusted):
    """DP with the Eq. 4 per-step mask + device backtrack + greedy repair.

    Returns ``(repaired candidate (B, K), DP surrogate cost (B,))``.
    """
    exec_cost, xfer, src_xfer = _surrogate_batch(
        seg_flops, seg_w, seg_priv, xbytes, t_in, t_out, lam, source,
        input_bytes_tok, bg, lbw, link_lat, flops_per_s, mem_bw, trusted, mem)
    C, parents = _migration_dp(exec_cost, xfer, n_segs, src_xfer)
    assign = _backtrack_rows(C, parents, n_segs)
    # batched Eq. 4 repair of the accumulation violations the DP's per-step
    # mask cannot express (several segments sharing one node)
    assign = _repair(seg_w, valid, n_segs, assign, mem, exec_cost, xfer,
                     src_xfer)
    return assign, C.amin(dim=1)


def _fixed_point(seg_flops, seg_w, seg_priv, seg_node0, valid, xbytes,
                 n_segs, t_in, t_out, lam, source, input_bytes_tok,
                 active, trig, force, slo,
                 base_bg, base_lbw, link_bw, link_lat, flops_per_s,
                 mem_bw, trusted, mem_bytes, *, weights: CostWeights,
                 mem_penalty: float, bw_floor: float, imp_frac: float,
                 max_sweeps: int):
    """Red/black fixed-point joint reconfiguration over the triggered set.

    The fused migrate prices every candidate against CYCLE-START residuals,
    so two simultaneous movers cannot see each other's landing.  This
    program is a sequential-consistency loop instead: rows are coloured by
    parity, and each half-sweep

    1. recomputes every row's EFFECTIVE state (bg / link bw / residual
       memory) from the fleet's *current* joint assignment — i.e. including
       all moves committed by earlier half-sweeps (the :func:`_price` fold
       with ``base_bg`` / ``base_lbw`` as the fold base, so the forecast
       worst-case base slots in unchanged),
    2. runs the migration DP + greedy Eq. 4 repair for ALL rows against
       those residuals,
    3. accepts a candidate only for triggered, active rows of the sweep's
       colour whose move is fleet-globally justified: the objective is each
       row's predicted SLO *breach-seconds* (``max(0, lat - slo)``), with
       the hysteresis latency test as the tie-break at equal breach,

    iterating until no row moves or the sweep budget is exhausted.  The loop
    runs on the host: one scalar read per sweep decides whether another
    sweep runs, and a converged sweep is a no-op, so the sweep count equals
    the reference's ``while_loop``.  A final JOINT Eq. 4 guard compares
    total fleet overflow at the fixed point against the starting assignment
    and reverts everything if the loop made it worse.  Rows never accept an
    Eq. 4-violating candidate (``cand_over``), but an overfull INCUMBENT may
    escape through a feasible candidate even without a latency gain
    (``escape``).

    The scalar reference is :func:`repro_torch.core.placement.
    fixed_point_reference` — the same schedule, op for op, in numpy.

    Returns ``(a_out, lat, sweeps, moved, moved_pre, abort, bg, lbw, mem,
    tot_node, tot_link, tot_w)``; ``sweeps`` is a host int.
    """
    B = seg_flops.shape[0]
    n = mem_bytes.shape[0]
    ev = dict(weights=weights, mem_penalty=mem_penalty)
    av = valid & active[:, None]
    w_av = torch.where(av, seg_w, 0.0)
    colour = (torch.arange(B, device=seg_flops.device) % 2) == 0

    def eff(a):
        # induced loads at joint assignment `a`, folded onto the base
        # capacities — the _price sequence with seg_node := a
        node_r, link_r, wb, _ = _induced(
            a, seg_flops, seg_w, valid, xbytes, t_in, t_out, lam, source,
            active, link_bw, flops_per_s, mem_bw)
        return (*_fold(node_r, link_r, wb, base_bg, base_lbw, mem_bytes,
                       bw_floor), wb)

    def lat_of(a, bg, lbw, mem):
        return _eval(seg_flops, seg_w, seg_priv, a, valid, xbytes, t_in,
                     t_out, lam, bg, lbw, link_lat, flops_per_s, mem_bw,
                     trusted, mem, **ev)

    def tot_over(ax):
        used = _scatter_rows(ax, w_av, n)
        return torch.clamp_min(used.sum(dim=0) - mem_bytes, 0.0).sum()

    def half(a, colour_mask):
        bg, lbw, mem, _, _, _, wb = eff(a)
        cand, _ = _migrate_rows(
            seg_flops, seg_w, seg_priv, valid, xbytes, n_segs, t_in, t_out,
            lam, source, input_bytes_tok, bg, lbw, mem, link_lat,
            flops_per_s, mem_bw, trusted)
        # invalid positions carry the incumbent so `changed` is clean
        cand = torch.where(valid, cand, a)
        cur_lat = lat_of(a, bg, lbw, mem)
        cand_lat = lat_of(cand, bg, lbw, mem)
        used_cand = _scatter_rows(cand, w_av, n)
        cand_over = (used_cand > mem).any(dim=1)
        cur_over = (wb > mem).any(dim=1)
        changed = (cand != a).any(dim=1)
        cur_breach = torch.clamp_min(cur_lat - slo, 0.0)
        cand_breach = torch.clamp_min(cand_lat - slo, 0.0)
        better = cand_lat < cur_lat * (1.0 - imp_frac)
        gain = (cand_breach < cur_breach) | (
            (cand_breach == cur_breach) & better)
        escape = cur_over & ~cand_over
        accept = (trig & active & colour_mask & changed & ~cand_over
                  & (gain | escape | force))
        a_new = torch.where(accept[:, None], cand, a)
        # fleet-global monotonicity: the colour's accepted moves only stand
        # if the TOTAL predicted breach-seconds — re-priced under the
        # residuals those moves induce — does not increase (or the moves
        # shrink total Eq. 4 overflow: storm escapes must land even at a
        # latency cost).  Each half-sweep is a descent step on the JOINT
        # objective, so an exhausted sweep budget can never commit a
        # mid-oscillation state worse than cycle start.
        bg2, lbw2, mem2, *_ = eff(a_new)
        new_lat = lat_of(a_new, bg2, lbw2, mem2)
        breach_cur = torch.where(
            active, torch.clamp_min(cur_lat - slo, 0.0), 0.0).sum()
        breach_new = torch.where(
            active, torch.clamp_min(new_lat - slo, 0.0), 0.0).sum()
        over_cur, over_new = tot_over(a), tot_over(a_new)
        # lexicographic descent on (total overflow, total breach)
        ok = (over_new <= over_cur) & (
            (breach_new <= breach_cur + 1e-9) | (over_new < over_cur))
        return torch.where(ok, a_new, a), ok & accept.any()

    a = seg_node0
    moved_pre = torch.zeros(B, dtype=torch.bool, device=a.device)
    sweeps, moved = 0, True
    while sweeps < max_sweeps and moved:
        a1, m1 = half(a, colour)
        a2, m2 = half(a1, ~colour)
        moved_pre = moved_pre | (a2 != a).any(dim=1)
        a = a2
        sweeps += 1
        moved = bool(m1 | m2)          # the one host read of the sweep

    # final joint Eq. 4 guard: the fixed point must not be worse than the
    # starting joint assignment in total fleet overflow
    abort = tot_over(a) > tot_over(seg_node0)
    a_out = torch.where(abort, seg_node0, a)
    moved_rows = moved_pre & (a_out != seg_node0).any(dim=1)
    bg, lbw, mem, tot_node, tot_link, tot_w, _ = eff(a_out)
    lat = lat_of(a_out, bg, lbw, mem)
    return (a_out, lat, sweeps, moved_rows, moved_pre, abort,
            bg, lbw, mem, tot_node, tot_link, tot_w)


@dataclass(frozen=True)
class FixedPointResult:
    """Device outputs of one fixed-point call (row-indexed).

    ``assign`` / ``lat`` are the JOINT fixed-point assignment and the
    latency each row sees under it; ``moved`` marks rows whose final
    assignment differs from cycle start (already accept-gated on device —
    the host commits them without re-checking hysteresis).  ``tot_*`` are
    the fleet totals AT the final assignment, so the caller can seed a
    residual table that is consistent with the committed moves without any
    per-commit refresh; ``bg`` / ``link_bw`` / ``mem`` are the matching
    per-row effective states for the re-split refinement stage.
    """

    assign: torch.Tensor     # (B, K) joint fixed-point assignment
    lat: torch.Tensor        # (B,)   latency at the joint assignment
    sweeps: int              # red/black sweeps run (incl. the converged one)
    moved: torch.Tensor      # (B,)   rows whose assignment changed (post-guard)
    moved_pre: torch.Tensor  # (B,)   rows that moved before the joint guard
    aborted: torch.Tensor    # ()     joint guard fired — all rows reverted
    bg: torch.Tensor         # (B, n) effective background util at `assign`
    link_bw: torch.Tensor    # (B, n, n) effective link bandwidth at `assign`
    mem: torch.Tensor        # (B, n) residual memory at `assign`
    tot_node: torch.Tensor   # (n,)   fleet-total induced node rho at `assign`
    tot_link: torch.Tensor   # (n, n) fleet-total link rho at `assign`
    tot_w: torch.Tensor      # (n,)   fleet-total resident bytes at `assign`


def _state_upload(dev: _OnDevice, states: Sequence[SystemState]) -> tuple:
    """The C(t) program arguments of S same-size states, stacked on a leading
    state axis: ``(bg0 (S, n), link_bw (S, n, n), link_lat (S, n, n),
    flops_per_s, mem_bw, trusted, mem_bytes (S, n))`` in ONE host→device
    copy, whatever S is (infinite links become ``_BIG``)."""
    S, n = len(states), states[0].num_nodes

    def stack(get, inf=False):
        a = np.stack([np.asarray(get(st), dtype=np.float64) for st in states])
        return np.nan_to_num(a, posinf=_BIG) if inf else a

    parts = [stack(lambda st: st.background_util),
             stack(lambda st: st.link_bw, inf=True),
             stack(lambda st: st.link_lat, inf=True),
             stack(lambda st: st.flops_per_s),
             stack(lambda st: st.mem_bw),
             stack(lambda st: np.asarray(st.trusted, dtype=bool)),
             stack(lambda st: st.mem_bytes)]
    flat = dev.t(np.concatenate([p.reshape(-1) for p in parts]))
    bg0, lbw, llat, fps, mbw, tr, mem = torch.split(
        flat, [S * n, S * n * n, S * n * n, S * n, S * n, S * n, S * n])
    return (bg0.reshape(S, n), lbw.reshape(S, n, n), llat.reshape(S, n, n),
            fps.reshape(S, n), mbw.reshape(S, n), tr.reshape(S, n) != 0.0,
            mem.reshape(S, n))


class ResidentFleetKernel(_OnDevice):
    """The fused monitoring-step programs over :class:`FleetStateBuffers`.

    Three programs: ``price`` (every cycle), ``migrate`` (legacy
    cycle-start-greedy path, on cycles with a non-empty triggered set) and
    ``migrate_fixed_point`` (the joint red/black loop).

    ``cost_model`` is the pricing provider the owning orchestrator threads
    through (calibration is an input transform on the packed rows — see
    :meth:`FleetCostEvaluator.pack`).
    """

    def __init__(self, cost_model: CostModel | None = None, *,
                 device: str | torch.device = "cuda") -> None:
        super().__init__(device=device)
        # fused-program calls (price + migrate + fixed point), mirroring
        # BatchedRepairPass.dispatches: the sharded equivalence tests assert
        # steady-state cycles cost exactly one call per shard
        self.dispatches = 0
        self.cost_model = cost_model if cost_model is not None \
            else AnalyticCostModel()

    def state_args(self, state: SystemState):
        """C(t) vectors uploaded once per cycle (one host→device copy);
        ``price`` and ``migrate`` share the same upload when the caller
        passes it through."""
        return tuple(a[0] for a in _state_upload(self, [state]))

    @staticmethod
    def _rows(buf: FleetStateBuffers):
        return (buf.seg_flops, buf.seg_wbytes, buf.seg_priv, buf.seg_node,
                buf.valid, buf.xfer_bytes_tok, buf.t_in, buf.t_out, buf.lam,
                buf.source, buf.active)

    def price(
        self,
        buf: FleetStateBuffers,
        state: SystemState,
        *,
        weights: CostWeights = CostWeights(),
        mem_penalty: float = 1e3,
        bw_floor: float = 0.05,
        state_args: tuple | None = None,
        forecaster=None,
        now: float | None = None,
    ) -> ResidentPrice:
        """``forecaster`` (a :class:`~repro_torch.core.forecast.
        CapacityForecaster`) fuses the seasonal forecast update + worst-case
        re-pricing into the same call; ``now`` gates ring advancement
        (``None`` → read-only call that observes but does not append)."""
        n = state.num_nodes
        if state_args is None:
            state_args = self.state_args(state)
        kw = dict(weights=weights, mem_penalty=float(mem_penalty),
                  bw_floor=float(bw_floor))
        self.dispatches += 1
        if forecaster is None:
            return ResidentPrice(*_price(*self._rows(buf), *state_args, **kw))
        cfg = forecaster.cfg
        fc_args, advance = forecaster.kernel_args(n, now)
        out = _price(*self._rows(buf), *state_args, **kw,
                     forecast=(*fc_args, cfg.horizon_steps,
                               cfg.residual_alpha))
        price = ResidentPrice(*out[:14])
        forecaster.commit(*out[16:], *out[14:16], advance=advance, now=now)
        return price

    def migrate(
        self,
        buf: FleetStateBuffers,
        price: ResidentPrice,
        state: SystemState,
        *,
        weights: CostWeights = CostWeights(),
        mem_penalty: float = 1e3,
        state_args: tuple | None = None,
        use_forecast: bool = False,
    ):
        """(repaired assignments (B, K), candidate latency (B,) priced on
        the repaired assignment, DP surrogate cost (B,)).

        Every row runs — triggered or not — so the triggered-set size never
        changes a shape.  ``use_forecast`` prices the DP surrogate and the
        candidates against the call's forecast effective state
        (``price.bg_fc`` / ``price.lbw_fc``) instead of the instantaneous
        one, so a proactive migration never targets a node that is about to
        spike."""
        if state_args is None:
            state_args = self.state_args(state)
        (_, _, link_lat, flops_per_s, mem_bw, trusted, _) = state_args
        bg, lbw = price.bg, price.link_bw
        if use_forecast and price.has_forecast:
            bg, lbw = price.bg_fc, price.lbw_fc
        self.dispatches += 1
        assign, cost = _migrate_rows(
            buf.seg_flops, buf.seg_wbytes, buf.seg_priv, buf.valid,
            buf.xfer_bytes_tok, buf.n_segs, buf.t_in, buf.t_out, buf.lam,
            buf.source, buf.input_bytes_tok, bg, lbw, price.mem,
            link_lat, flops_per_s, mem_bw, trusted)
        mig_lat = _eval(buf.seg_flops, buf.seg_wbytes, buf.seg_priv, assign,
                        buf.valid, buf.xfer_bytes_tok, buf.t_in, buf.t_out,
                        buf.lam, bg, lbw, link_lat, flops_per_s, mem_bw,
                        trusted, price.mem, weights=weights,
                        mem_penalty=mem_penalty)
        return assign, mig_lat, cost

    def migrate_fixed_point(
        self,
        buf: FleetStateBuffers,
        state: SystemState,
        *,
        trig: np.ndarray,
        force: np.ndarray,
        slo: np.ndarray,
        weights: CostWeights = CostWeights(),
        mem_penalty: float = 1e3,
        bw_floor: float = 0.05,
        min_improvement_frac: float = 0.10,
        max_sweeps: int = 8,
        state_args: tuple | None = None,
        base_bg: np.ndarray | None = None,
        base_lbw: np.ndarray | None = None,
    ) -> FixedPointResult:
        """One call: red/black fixed point over the triggered set.

        ``trig`` / ``force`` / ``slo`` are (n_rows,) row-indexed masks/SLOs;
        a forced row (failure storm) accepts any feasible change regardless
        of gain.  ``base_bg`` / ``base_lbw`` override the fold base with the
        forecast worst-case capacities (``None`` keeps the instantaneous
        C(t), matching the reactive path); induced-load denominators always
        use the instantaneous link matrix, exactly like the fused forecast
        pricing.  Needs no :class:`ResidentPrice` — the program recomputes
        effective state per half-sweep from the evolving joint assignment.
        """
        if state_args is None:
            state_args = self.state_args(state)
        (bg0, link_bw, link_lat, flops_per_s, mem_bw, trusted,
         mem_bytes) = state_args
        bb = bg0 if base_bg is None else self.t(
            np.asarray(base_bg, dtype=np.float64))
        bl = link_bw if base_lbw is None else self.t(np.nan_to_num(
            np.asarray(base_lbw, dtype=np.float64), posinf=_BIG))
        self.dispatches += 1
        out = _fixed_point(
            buf.seg_flops, buf.seg_wbytes, buf.seg_priv, buf.seg_node,
            buf.valid, buf.xfer_bytes_tok, buf.n_segs, buf.t_in,
            buf.t_out, buf.lam, buf.source, buf.input_bytes_tok,
            buf.active, self.t(np.asarray(trig, dtype=bool), torch.bool),
            self.t(np.asarray(force, dtype=bool), torch.bool),
            self.t(np.asarray(slo, dtype=np.float64)),
            bb, bl, link_bw, link_lat, flops_per_s, mem_bw, trusted,
            mem_bytes, weights=weights, mem_penalty=float(mem_penalty),
            bw_floor=float(bw_floor), imp_frac=float(min_improvement_frac),
            max_sweeps=int(max_sweeps),
        )
        return FixedPointResult(*out)


# --------------------------------------------------------------------------- #
# region-sharded resident fleet state
# --------------------------------------------------------------------------- #
_SCREEN_ROW_ARGS = ("seg_flops", "seg_wbytes", "seg_priv", "seg_node",
                    "valid", "xfer_bytes_tok", "t_in", "t_out", "lam",
                    "source", "active")


def _screen_one(*args, weights: CostWeights, mem_penalty: float,
                bw_floor: float):
    """One shard of the cross-shard screen: :func:`_price` against the
    shard's own C(t), reduced to what the screen returns — the trigger-env
    scalars and the per-shard totals (the (B, n, n) effective states never
    leave the call)."""
    lat, max_util, min_bw, _, _, _, tot_node, _, tot_w = _price(
        *args, weights=weights, mem_penalty=mem_penalty, bw_floor=bw_floor)
    return lat, max_util, min_bw, tot_node, tot_w


@dataclass(frozen=True)
class ShardScreen:
    """Host-side outputs of one cross-shard screen call.

    Row ``[s, b]`` is shard ``s``'s buffer row ``b`` (inactive rows carry
    zero loads and garbage trigger scalars — mask with each shard's
    ``active``).  The per-shard totals are what the cross-region aggregator
    ranks residual headroom with.
    """

    lat: np.ndarray       # (S, B) current-config latency per row
    max_util: np.ndarray  # (S, B) trigger env: max node util per row
    min_bw: np.ndarray    # (S, B) trigger env: min cross-hop bandwidth
    tot_node: np.ndarray  # (S, n) per-shard induced node rho totals
    tot_w: np.ndarray     # (S, n) per-shard resident weight-byte totals


class ShardedFleetState:
    """One (:class:`FleetStateBuffers`, :class:`ResidentFleetKernel`) pair
    per MEC region, plus the stacked screen across them.

    Shards are fully load-disjoint by construction: every session is placed
    on its own region's nodes only, so per-shard pricing against the
    region-local C(t) is *exact*, not an approximation — the block-diagonal
    fleet decomposes.  The screen stacks all shards' row tensors (shapes
    synchronized to the max shard first) and prices them in one call —
    :func:`_price` mapped over the shard axis with ``torch.func.vmap``, so
    the folds stay the per-slot, atomic-free ones of the per-shard price —
    and the per-region fixed point / migrate / re-split machinery then runs
    only on shards whose screen shows trigger activity.
    """

    def __init__(self, shards: Sequence[FleetStateBuffers],
                 kernels: Sequence["ResidentFleetKernel"]) -> None:
        if len(shards) != len(kernels):
            raise ValueError("one kernel per shard required")
        self.shards = list(shards)
        self.kernels = list(kernels)
        self.screen_dispatches = 0
        # stacked (S, B, K) row block, kept on the device across cycles and
        # refreshed per shard by buffer mutation stamp: a quiet cycle
        # re-uploads NOTHING, so the screen's host cost is O(dirty shards)
        self._stack: tuple | None = None
        self._stack_key: tuple | None = None
        self._stack_vers: list[int] = []

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def sync_shapes(self) -> tuple[int, int]:
        """Grow every shard to the fleet-max (rows, segs) so the stacked
        screen sees one uniform (S, B, K) block.  Both axes only ever grow
        (pow2), so this settles immediately in steady state; growth keeps
        every row where it was."""
        rows = max(b.n_rows for b in self.shards)
        segs = max(b.max_segs for b in self.shards)
        for b in self.shards:
            if b.max_segs < segs:
                b._grow_segs(segs)
            if b.n_rows < rows:
                b._grow_rows(rows)
        return rows, segs

    def screen(self, states: Sequence[SystemState], *,
               weights: CostWeights = CostWeights(),
               mem_penalty: float = 1e3,
               bw_floor: float = 0.05) -> ShardScreen:
        """Price every shard against its regional C(t) in ONE call; the
        (S, B) trigger scalars and (S, n) totals come to the host in one
        transfer."""
        S = self.n_shards
        if len(states) != S:
            raise ValueError(f"{len(states)} states for {S} shards")
        n = states[0].num_nodes
        if any(st.num_nodes != n for st in states):
            raise ValueError("regional states must share a node count")
        rows, segs = self.sync_shapes()
        row_args = self._stacked_rows(S, rows, segs)
        # one host stack + one upload for every shard's C(t)
        state_args = _state_upload(self.kernels[0], states)
        fn = torch.func.vmap(functools.partial(
            _screen_one, weights=weights, mem_penalty=float(mem_penalty),
            bw_floor=float(bw_floor)))
        out = fn(*row_args, *state_args)
        self.screen_dispatches += 1
        return ShardScreen(*to_host(*out))

    def _stacked_rows(self, S: int, rows: int, segs: int) -> tuple:
        """The (S, B, K) stacked row block, rewritten only where buffers
        actually changed since the last screen.  Shards report mutations
        through ``FleetStateBuffers.version`` (globally-unique stamps), so
        a steady-state cycle reuses the device block verbatim; a cycle that
        admitted/migrated in d shards copies d slices in place.  When more
        than a quarter of the fleet is dirty (cold start, growth resync) a
        full restack is cheaper than per-slice copies."""
        vers = [b.version for b in self.shards]
        skey = (S, rows, segs)
        dirty = ([r for r, v in enumerate(vers)
                  if v != self._stack_vers[r]]
                 if self._stack is not None and self._stack_key == skey
                 else None)
        if dirty is None or len(dirty) > max(1, S // 4):
            self._stack = tuple(
                torch.stack([getattr(b, f) for b in self.shards])
                for f in _SCREEN_ROW_ARGS
            )
        else:
            for r in dirty:
                b = self.shards[r]
                for f, a in zip(_SCREEN_ROW_ARGS, self._stack):
                    a[r].copy_(getattr(b, f))
        self._stack_key = skey
        self._stack_vers = vers
        return self._stack
