"""Split Revision (SR) — joint split + placement solver (paper Eq. 6/8).

Solves  min_{S ∈ Ω, x} Φ(x, S, C(t))  over contiguous splitting schemes Ω.

The exact chain formulation: a state (l, j) = "layers [0, l) are covered and
the segment ending at l runs on node j".  Transition

    C[l2, j2] = min_{l1 < l2, j1}  C[l1, j1] + xfer(b=l1, j1→j2) + exec([l1,l2), j2)

is a shortest path in a layered DAG — O(L²·n²), exact for the additive
surrogate (privacy constraints enter as +inf masks).  Two implementations:

* :func:`solve_joint_dp` — numpy, vectorized inner loops (reference).
* :class:`TorchJointSplitter` — the same DP as float32 tensor code on a
  torch device, one step per l2; the backtrack runs on the host.
* :class:`BatchedJointSplitter` — the same float32 DP over a leading
  *session* axis: a bucket of sessions sharing one ``SystemState`` (equal
  coarsened unit count) resolves in one pass of L steps, not a Python loop
  over sessions.  This is the fleet path: the multi-session orchestrator
  (:mod:`repro_torch.core.fleet`) re-splits its triggered set per cycle.
  Buckets are padded to the next power of two, as in the reference.

All are followed by :func:`repro_torch.core.placement.local_search` on the
full Φ (queueing + imbalance terms), and :func:`brute_force_joint` exists for
tests.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .cost_model import (AnalyticCostModel, CostModel, SystemState, Workload,
                         evaluate, memory_violations)
from .graph import ModelGraph
from .placement import (Solution, local_search, repair_capacity,
                        restrict_state, select_candidate_nodes, surrogate_cost)

__all__ = [
    "solve_joint_dp",
    "brute_force_joint",
    "TorchJointSplitter",
    "BatchedJointSplitter",
    "PackedProblem",
    "pack_problem",
    "SessionProblem",
    "coalesce_same_node",
    "SplitRevision",
]

_INF = float("inf")
_BIG = 1e30  # finite stand-in for +inf in the float32 device DP


@dataclass(frozen=True)
class PackedProblem:
    """State-independent DP inputs for one (graph, coarsening, input width).

    Everything here depends only on the model graph, the coarsening cap it
    was built with, and the ingress byte width — NOT on C(t).  Callers that
    re-solve the same problem against a moving state (the admission defer
    queue re-pricing a parked request every poll) compute this once and pass
    it back through :attr:`SessionProblem.prepacked`; the per-solve work is
    then only the state-dependent transfer matrix and effective rates.
    """

    graph: ModelGraph               # the graph this pack was built FROM
    flops_ps: np.ndarray            # (L+1,) FLOPs/token prefix sums
    wbytes_ps: np.ndarray           # (L+1,) weight-byte prefix sums
    priv_ps: np.ndarray             # (L+1,) privacy-count prefix sums
    boundary_bytes: np.ndarray      # (L+1,) bytes/token cut at l; [0]=ingress
    unit_map: tuple[int, ...]       # coarse unit i ends before unit_map[i]
    units: int | None               # the coarsen cap this was built with
    input_bytes_per_token: float

    @property
    def L(self) -> int:
        return len(self.unit_map)


def pack_problem(
    graph: ModelGraph,
    *,
    units: int | None = None,
    input_bytes_per_token: float = 4.0,
) -> PackedProblem:
    """Coarsen + prefix-sum a graph into its reusable DP form (O(L), once)."""
    flops = graph.flops
    wbytes = graph.weight_bytes
    abytes = graph.act_out_bytes
    priv = graph.privacy.astype(np.float64)
    if units is not None and len(graph) > units:
        # coarsen: group consecutive units so the DP stays small on huge graphs
        groups = np.array_split(np.arange(len(graph)), units)
        flops = np.array([graph.flops[g].sum() for g in groups])
        wbytes = np.array([graph.weight_bytes[g].sum() for g in groups])
        abytes = np.array([graph.act_out_bytes[g[-1]] for g in groups])
        priv = np.array([graph.privacy[g].any() for g in groups], dtype=np.float64)
        unit_map = [int(g[-1]) + 1 for g in groups]  # group i ends before unit_map[i]
    else:
        unit_map = list(range(1, len(graph) + 1))
    L = len(flops)
    flops_ps = np.concatenate([[0.0], np.cumsum(flops)])
    wbytes_ps = np.concatenate([[0.0], np.cumsum(wbytes)])
    priv_ps = np.concatenate([[0.0], np.cumsum(priv)])
    # boundary bytes per token when cutting at l (l=0 is the raw input)
    bb = np.zeros(L + 1)
    bb[0] = input_bytes_per_token
    bb[1:L] = abytes[: L - 1]
    return PackedProblem(graph, flops_ps, wbytes_ps, priv_ps, bb,
                         tuple(unit_map), units, float(input_bytes_per_token))


def _problem_arrays(
    graph: ModelGraph,
    state: SystemState,
    wl: Workload,
    *,
    source_node: int,
    input_bytes_per_token: float,
    max_units: int | None = None,
    prepacked: PackedProblem | None = None,
):
    """Pack the DP inputs into dense arrays (optionally coarsened).

    ``prepacked`` skips the state-independent half when it matches the
    requested (graph, coarsening, input width); any mismatch — including a
    pack built from a DIFFERENT graph object — silently repacks, so a stale
    cache can never deploy another graph's boundaries.
    """
    pp = prepacked
    if (pp is None or pp.graph is not graph or pp.units != max_units
            or pp.input_bytes_per_token != float(input_bytes_per_token)):
        pp = pack_problem(graph, units=max_units,
                          input_bytes_per_token=input_bytes_per_token)
    L = pp.L
    derate = np.maximum(1e-12, 1.0 - state.background_util)
    eff_f = state.flops_per_s * derate
    eff_m = state.mem_bw * derate
    # boundary bytes stay a (L+1,) vector: the device DPs expand them to the
    # (L+1, n, n) transfer tensor ON DEVICE (see _xfer_matrix / _make_dp), so
    # the per-solve host work and upload are O(L), not O(L·n²)
    return (pp.flops_ps, pp.wbytes_ps, pp.priv_ps, pp.boundary_bytes,
            eff_f, eff_m, list(pp.unit_map), L)


def _xfer_matrix(bb: np.ndarray, tokens: float, state: SystemState) -> np.ndarray:
    """(L+1, n, n) transfer tensor for the numpy reference DP."""
    xfer = bb[:, None, None] * tokens / np.maximum(state.link_bw, 1e-12)[None] + (
        state.link_lat[None] * (bb[:, None, None] > 0)
    )
    idx = np.arange(state.num_nodes)
    xfer[:, idx, idx] = 0.0  # same node: no transfer
    return xfer


def _backtrack(
    C: np.ndarray,
    par_l: np.ndarray,
    par_j: np.ndarray,
    unit_map: Sequence[int],
    L: int,
) -> Solution:
    """Recover the optimal (boundaries, assignment) from DP tables."""
    j = int(np.argmin(C[L]))
    cost = float(C[L, j])
    bounds, assign = [L], []
    l = L
    while l > 0:
        assign.append(j)
        l, j = int(par_l[l, j]), int(par_j[l, j])
        bounds.append(l)
    bounds.reverse()
    assign.reverse()
    boundaries = tuple(unit_map[b - 1] if b > 0 else 0 for b in bounds)
    return Solution(boundaries, tuple(assign), cost)


# --------------------------------------------------------------------------- #
# numpy reference DP
# --------------------------------------------------------------------------- #
def solve_joint_dp(
    graph: ModelGraph,
    state: SystemState,
    wl: Workload,
    *,
    source_node: int = 0,
    input_bytes_per_token: float = 4.0,
    max_units: int | None = None,
) -> Solution:
    n = state.num_nodes
    flops_ps, wbytes_ps, priv_ps, bb, eff_f, eff_m, unit_map, L = _problem_arrays(
        graph, state, wl, source_node=source_node,
        input_bytes_per_token=input_bytes_per_token, max_units=max_units,
    )
    xfer = _xfer_matrix(bb, float(wl.total_tokens), state)
    untrusted = ~state.trusted.astype(bool)
    t_in, t_out = float(wl.tokens_in), float(wl.tokens_out)
    lam = float(wl.arrival_rate)

    C = np.full((L + 1, n), _INF)
    par_l = np.zeros((L + 1, n), dtype=np.int64)
    par_j = np.zeros((L + 1, n), dtype=np.int64)
    # virtual start: layers [0,0) covered, "previous node" = source
    for l2 in range(1, L + 1):
        l1s = np.arange(l2)  # candidate previous boundaries
        seg_flops = flops_ps[l2] - flops_ps[l1s]                      # (l1,)
        seg_w = wbytes_ps[l2] - wbytes_ps[l1s]                        # (l1,)
        seg_priv = (priv_ps[l2] - priv_ps[l1s]) > 0                   # (l1,)
        ft = seg_flops[:, None] / eff_f[None, :]                      # (l1, j2)
        svc = t_in * ft + t_out * np.maximum(ft, seg_w[:, None] / eff_m[None, :])
        load = np.minimum(lam * svc, 0.9)
        exec_c = svc / (1.0 - load)
        exec_c = np.where(seg_priv[:, None] & untrusted[None, :], _INF, exec_c)
        # prev cost: C[l1, j1] except l1=0 which is cost 0 at node=source
        prev = C[l1s]                                                 # (l1, j1)
        prev[0] = _INF
        prev[0, source_node] = 0.0
        cand = prev[:, :, None] + xfer[l1s] + exec_c[:, None, :]      # (l1, j1, j2)
        flat = cand.reshape(-1, n)
        best = np.argmin(flat, axis=0)
        C[l2] = flat[best, np.arange(n)]
        par_l[l2] = l1s[best // n]
        par_j[l2] = best % n

    return _backtrack(C, par_l, par_j, unit_map, L)


# --------------------------------------------------------------------------- #
# float32 device DP — the production path
# --------------------------------------------------------------------------- #
def _device_dp(flops_ps, wbytes_ps, priv_ps, bb, eff_f, eff_m, t_in, t_out,
               lam, untrusted, source_onehot, link_bw, link_lat):
    """Float32 DPs over B sessions' (L+1, n) lattices; all inputs on one device.

    The session axis leads: ``flops_ps``/``wbytes_ps``/``priv_ps``/``bb`` are
    (B, L+1), ``t_in``/``t_out``/``lam`` (B,), ``source_onehot`` (B, n); the
    node rates, trust mask and link matrices are shared by the bucket.  Each
    step prices every l1 (invalid ones masked to ``_BIG``) so every step has
    the same shape, and one step serves every session.  ``argmin`` returns
    the first minimum, so ties break as in the numpy reference.  Returns the
    (B, L+1, n) cost tables and parent tables.
    """
    dev = flops_ps.device
    B, L1 = flops_ps.shape
    L = L1 - 1
    n = eff_f.shape[0]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tokens = (t_in + t_out)[:, None, None, None]
    bb4 = bb[:, :, None, None]
    xfer = (bb4 * tokens / torch.clamp_min(link_bw, 1e-12)
            + link_lat * (bb4 > 0))                          # (B, L+1, n, n)
    xfer = torch.where(torch.eye(n, dtype=torch.bool, device=dev),
                       zero, xfer)
    l1s = torch.arange(L + 1, device=dev)
    first = (l1s == 0)[None, :, None]
    start = torch.where(source_onehot > 0, zero, big)[:, None, :]
    t_in3, t_out3, lam3 = t_in[:, None, None], t_out[:, None, None], \
        lam[:, None, None]
    C = torch.full((B, L + 1, n), _BIG, dtype=torch.float32, device=dev)
    par_l = torch.zeros((B, L + 1, n), dtype=torch.int64, device=dev)
    par_j = torch.zeros((B, L + 1, n), dtype=torch.int64, device=dev)
    for l2 in range(1, L + 1):
        seg_flops = flops_ps[:, l2:l2 + 1] - flops_ps              # (B, L+1)
        seg_w = wbytes_ps[:, l2:l2 + 1] - wbytes_ps
        seg_priv = (priv_ps[:, l2:l2 + 1] - priv_ps) > 0
        ft = seg_flops[:, :, None] / eff_f                         # (B, L+1, n)
        svc = t_in3 * ft + t_out3 * torch.maximum(
            ft, seg_w[:, :, None] / eff_m)
        load = torch.clamp_max(lam3 * svc, 0.9)
        exec_c = svc / (1.0 - load)
        exec_c = torch.where(seg_priv[:, :, None] & untrusted, big, exec_c)
        prev = torch.where(first, start, C)
        cand = prev[:, :, :, None] + xfer + exec_c[:, :, None, :]
        cand = torch.where((l1s < l2)[None, :, None, None], cand, big)
        flat = cand.reshape(B, -1, n)
        best = torch.argmin(flat, dim=1)                           # (B, n)
        C[:, l2] = flat.gather(1, best[:, None, :])[:, 0]
        par_l[:, l2] = best // n
        par_j[:, l2] = best % n
    return C, par_l, par_j


def _f32(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=device)


class TorchJointSplitter:
    """The joint DP in float32 on ``device``; re-solved per C(t) tick.

    Float32 throughout, ``_BIG`` for +inf and first-index argmin, as the
    reference's jitted DP, so boundaries and assignment come out the same;
    the optimal cost agrees to float32 rounding (a compiler may fuse a
    multiply-add that runs here as two roundings).  ``cost_model`` selects
    the pricing provider through its calibrated graph view.
    """

    def __init__(self, cost_model: CostModel | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.cost_model = cost_model if cost_model is not None \
            else AnalyticCostModel()

    def solve(
        self,
        graph: ModelGraph,
        state: SystemState,
        wl: Workload,
        *,
        source_node: int = 0,
        input_bytes_per_token: float = 4.0,
        max_units: int | None = None,
    ) -> Solution:
        [sol] = BatchedJointSplitter(
            cost_model=self.cost_model, device=self.device,
        ).solve_batch([SessionProblem(
            graph, wl, source_node=source_node,
            input_bytes_per_token=input_bytes_per_token,
        )], state, max_units=max_units)
        return sol


# --------------------------------------------------------------------------- #
# batched DP (leading session axis) — the fleet path
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class SessionProblem:
    """One session's inputs to the batched joint DP.

    Sessions in a batch share the fleet ``SystemState`` but differ in model
    graph (hence privacy mask), workload, ingress node, and input width.
    ``prepacked`` (see :func:`pack_problem`) carries the state-independent
    arrays across repeated solves of the same problem.
    """

    graph: ModelGraph
    workload: Workload
    source_node: int = 0
    input_bytes_per_token: float = 4.0
    prepacked: PackedProblem | None = None


class BatchedJointSplitter:
    """Joint split+placement for MANY sessions in one device pass.

    :func:`_device_dp` carries a batch axis of (flops/weight/privacy prefix
    sums, boundary bytes, workload scalars, source one-hots); node capacities
    and the trust set are broadcast.  Sessions are bucketed by coarsened unit
    count L so graphs of different depth never force padding of the DP
    lattice itself; within a bucket the batch dimension is padded to the next
    power of two (repeating the bucket's last session), as in the reference.

    ``shared_units`` is the shared-coarsening policy: every graph at least
    that deep is coarsened to EXACTLY ``shared_units`` DP units, so a
    heterogeneous catalog (34–64-layer archs) collapses into ONE bucket.
    Graphs shallower than the cap keep their native depth (units cannot be
    manufactured).  ``None`` preserves the per-depth bucketing.

    Float32, ``_BIG`` for +inf and first-index argmin, like
    :class:`TorchJointSplitter`; equivalent to per-session
    :func:`solve_joint_dp` on the additive surrogate.
    """

    def __init__(self, *, shared_units: int | None = None,
                 cost_model: CostModel | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.shared_units = shared_units
        self.device = resolve_device(device)
        self.cost_model = cost_model if cost_model is not None \
            else AnalyticCostModel()

    def units_for(self, graph_len: int, max_units: int | None) -> int | None:
        """Effective coarsen cap for a graph under the shared-units policy.

        ``None`` means "no coarsening" — returned for graphs already at or
        below the cap, so this method (not the pack) is authoritative for
        the shallow-graph exemption.
        """
        u = max_units
        if self.shared_units is not None:
            u = self.shared_units if u is None else min(u, self.shared_units)
        return None if u is None or graph_len <= u else u

    def pack_problem(
        self,
        graph: ModelGraph,
        *,
        max_units: int | None = None,
        input_bytes_per_token: float = 4.0,
    ) -> PackedProblem:
        """Policy-consistent :func:`pack_problem` (cacheable per request)."""
        graph = self.cost_model.calibrated(graph)
        return pack_problem(
            graph,
            units=self.units_for(len(graph), max_units),
            input_bytes_per_token=input_bytes_per_token,
        )

    def solve_batch(
        self,
        problems: Sequence[SessionProblem],
        state: SystemState,
        *,
        max_units: int | None = None,
    ) -> list[Solution]:
        if not problems:
            return []
        n = state.num_nodes
        dev = self.device
        untrusted = torch.as_tensor(~state.trusted.astype(bool), device=dev)

        # pack per-session arrays, bucketing by coarsened DP depth L
        # (shared_units collapses heterogeneous depths into one bucket)
        packed = []
        buckets: dict[int, list[int]] = {}
        for i, p in enumerate(problems):
            arrs = _problem_arrays(
                self.cost_model.calibrated(p.graph), state, p.workload,
                source_node=p.source_node,
                input_bytes_per_token=p.input_bytes_per_token,
                max_units=self.units_for(len(p.graph), max_units),
                prepacked=p.prepacked,
            )
            packed.append(arrs)
            buckets.setdefault(arrs[-1], []).append(i)

        out: list[Solution | None] = [None] * len(problems)
        for L, idxs in buckets.items():
            B = len(idxs)
            Bp = 1 << (B - 1).bit_length()
            rows = idxs + [idxs[-1]] * (Bp - B)
            src = np.zeros((Bp, n))
            src[np.arange(Bp), [problems[i].source_node for i in rows]] = 1.0
            # eff_f/eff_m identical across the bucket (shared state)
            eff_f, eff_m = packed[idxs[0]][4], packed[idxs[0]][5]
            C, par_l, par_j = _device_dp(
                *(_f32(np.stack([packed[i][k] for i in rows]), dev)
                  for k in range(4)),
                _f32(eff_f, dev), _f32(eff_m, dev),
                _f32([problems[i].workload.tokens_in for i in rows], dev),
                _f32([problems[i].workload.tokens_out for i in rows], dev),
                _f32([problems[i].workload.arrival_rate for i in rows], dev),
                untrusted, _f32(src, dev),
                _f32(state.link_bw, dev), _f32(state.link_lat, dev),
            )
            C, par_l, par_j = (C[:B].cpu().numpy(), par_l[:B].cpu().numpy(),
                               par_j[:B].cpu().numpy())
            for b, i in enumerate(idxs):
                out[i] = _backtrack(C[b], par_l[b], par_j[b], packed[i][6], L)
        return out  # type: ignore[return-value]


# --------------------------------------------------------------------------- #
# exhaustive oracle (tests only; tiny instances)
# --------------------------------------------------------------------------- #
def brute_force_joint(
    graph: ModelGraph,
    state: SystemState,
    wl: Workload,
    *,
    source_node: int = 0,
    input_bytes_per_token: float = 4.0,
) -> Solution:
    L, n = len(graph), state.num_nodes
    best: Solution | None = None
    for r in range(L):  # choose interior boundaries
        for cuts in itertools.combinations(range(1, L), r):
            bounds = (0, *cuts, L)
            for assign in itertools.product(range(n), repeat=len(bounds) - 1):
                c = surrogate_cost(
                    graph, bounds, assign, state, wl,
                    source_node=source_node,
                    input_bytes_per_token=input_bytes_per_token,
                )
                if best is None or c < best.cost:
                    best = Solution(bounds, tuple(assign), c)
    assert best is not None
    return best


# --------------------------------------------------------------------------- #
# the SR module
# --------------------------------------------------------------------------- #
def coalesce_same_node(sol: Solution, cost: float | None = None) -> Solution:
    """Merge adjacent segments assigned to the same node (cost-neutral)."""
    b, a = list(sol.boundaries), list(sol.assignment)
    j = 0
    while j < len(a) - 1:
        if a[j] == a[j + 1]:
            del b[j + 1]
            del a[j + 1]
        else:
            j += 1
    return Solution(tuple(b), tuple(a), sol.cost if cost is None else cost)


@dataclass
class SplitRevision:
    """Paper's SR module: the device DP, then full-Φ refinement.

    ``strategy`` is ``"dp+local"`` (the DP, then the Φ local search) or
    ``"dp"`` (the DP's answer, re-priced by Φ, no local search).
    ``device`` is where the DP runs; it defaults to ``"cuda"`` and raises
    when no card is present unless ``"cpu"`` is asked for.
    """

    strategy: str = "dp+local"          # "dp" or "dp+local"
    max_units: int | None = 96          # DP coarsening cap for huge graphs
    max_nodes: int = 16                 # candidate-node pruning cap
    local_rounds: int = 12              # Φ local-search budget per revision
    cost_model: CostModel | None = None  # pricing provider (None = analytic)
    device: str | torch.device = "cuda"
    _dp: TorchJointSplitter | None = None

    def __post_init__(self) -> None:
        if self.cost_model is None:
            self.cost_model = AnalyticCostModel()
        self._dp = TorchJointSplitter(self.cost_model, self.device)

    def warmup(
        self,
        graph: ModelGraph,
        state: SystemState,
        wl: Workload,
        *,
        source_node: int = 0,
    ) -> None:
        """Run the device DP once on the state ``revise`` would use.

        Called at deployment time so that the first triggered re-split does
        not pay the device's first-use costs (allocator, kernel loading)
        inside its measured decision cycle.
        """
        graph = self.cost_model.calibrated(graph)
        _, sub, sub_source = self._pruned(state, source_node)
        self._dp.solve(
            graph, sub, wl, source_node=sub_source, max_units=self.max_units
        )

    def _pruned(self, state: SystemState, source_node: int):
        """Candidate-node pruning shared by ``warmup`` and ``revise``."""
        idx = select_candidate_nodes(
            state, k=self.max_nodes, source_node=source_node
        )
        sub = restrict_state(state, idx) if len(idx) < state.num_nodes else state
        return idx, sub, int(np.searchsorted(idx, source_node))

    def revise(
        self,
        graph: ModelGraph,
        state: SystemState,
        wl: Workload,
        *,
        source_node: int = 0,
    ) -> Solution:
        # calibrate once; every downstream Φ/feasibility call prices the view
        graph = self.cost_model.calibrated(graph)
        # fleet-scale pruning: DP over the k most promising nodes only
        idx, sub, sub_source = self._pruned(state, source_node)

        sol = self._dp.solve(
            graph, sub, wl, source_node=sub_source, max_units=self.max_units
        )
        sol = coalesce_same_node(sol)
        if self.strategy == "dp":
            sol = Solution(
                sol.boundaries, sol.assignment,
                evaluate(graph, sol.boundaries, sol.assignment, sub, wl),
            )
        else:
            sol = local_search(graph, sol, sub, wl, max_rounds=self.local_rounds)
        # Eq. 4 repair only when actually violated
        if memory_violations(graph, sol.boundaries, sol.assignment, sub).any():
            sol = repair_capacity(graph, sol, sub, wl)
        sol = coalesce_same_node(sol)
        if len(idx) < state.num_nodes:  # map back to fleet node ids
            sol = Solution(
                sol.boundaries,
                tuple(int(idx[a]) for a in sol.assignment),
                sol.cost,
            )
        return sol
