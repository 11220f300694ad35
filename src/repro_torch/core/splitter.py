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

Both are followed by :func:`repro_torch.core.placement.local_search` on the
full Φ (queueing + imbalance terms).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .cost_model import (AnalyticCostModel, CostModel, SystemState, Workload,
                         memory_violations)
from .graph import ModelGraph
from .placement import (Solution, local_search, repair_capacity,
                        restrict_state, select_candidate_nodes)

__all__ = [
    "solve_joint_dp",
    "TorchJointSplitter",
    "coalesce_same_node",
    "SplitRevision",
]

_INF = float("inf")
_BIG = 1e30  # finite stand-in for +inf in the float32 device DP


def _problem_arrays(
    graph: ModelGraph,
    state: SystemState,
    *,
    input_bytes_per_token: float,
    max_units: int | None = None,
):
    """Pack the DP inputs into dense arrays (optionally coarsened)."""
    flops = graph.flops
    wbytes = graph.weight_bytes
    abytes = graph.act_out_bytes
    priv = graph.privacy.astype(np.float64)
    if max_units is not None and len(graph) > max_units:
        # coarsen: group consecutive units so the DP stays small on huge graphs
        groups = np.array_split(np.arange(len(graph)), max_units)
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
    derate = np.maximum(1e-12, 1.0 - state.background_util)
    eff_f = state.flops_per_s * derate
    eff_m = state.mem_bw * derate
    return flops_ps, wbytes_ps, priv_ps, bb, eff_f, eff_m, unit_map, L


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
        graph, state, input_bytes_per_token=input_bytes_per_token,
        max_units=max_units,
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
    """One float32 DP over the (L+1, n) lattice; all inputs on one device.

    Each step prices every l1 (invalid ones masked to ``_BIG``) so every step
    has the same shape.  ``argmin`` returns the first minimum, so ties break
    as in the numpy reference.  Returns the (L+1, n) cost table and parent
    tables.
    """
    dev = flops_ps.device
    L = flops_ps.shape[0] - 1
    n = eff_f.shape[0]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tokens = t_in + t_out
    xfer = (bb[:, None, None] * tokens / torch.clamp_min(link_bw, 1e-12)
            + link_lat * (bb[:, None, None] > 0))
    xfer = torch.where(torch.eye(n, dtype=torch.bool, device=dev)[None],
                       zero, xfer)
    l1s = torch.arange(L + 1, device=dev)
    first = (l1s == 0)[:, None]
    start = torch.where(source_onehot > 0, zero, big)[None, :]
    C = torch.full((L + 1, n), _BIG, dtype=torch.float32, device=dev)
    par_l = torch.zeros((L + 1, n), dtype=torch.int64, device=dev)
    par_j = torch.zeros((L + 1, n), dtype=torch.int64, device=dev)
    for l2 in range(1, L + 1):
        seg_flops = flops_ps[l2] - flops_ps
        seg_w = wbytes_ps[l2] - wbytes_ps
        seg_priv = (priv_ps[l2] - priv_ps) > 0
        ft = seg_flops[:, None] / eff_f[None, :]
        svc = t_in * ft + t_out * torch.maximum(ft, seg_w[:, None] / eff_m[None, :])
        load = torch.clamp_max(lam * svc, 0.9)
        exec_c = svc / (1.0 - load)
        exec_c = torch.where(seg_priv[:, None] & untrusted[None, :], big, exec_c)
        prev = torch.where(first, start, C)
        cand = prev[:, :, None] + xfer + exec_c[:, None, :]
        cand = torch.where((l1s < l2)[:, None, None], cand, big)
        flat = cand.reshape(-1, n)
        best = torch.argmin(flat, dim=0)
        C[l2] = flat.gather(0, best[None, :])[0]
        par_l[l2] = best // n
        par_j[l2] = best % n
    return C, par_l, par_j


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
        graph = self.cost_model.calibrated(graph)
        n = state.num_nodes
        flops_ps, wbytes_ps, priv_ps, bb, eff_f, eff_m, unit_map, L = _problem_arrays(
            graph, state, input_bytes_per_token=input_bytes_per_token,
            max_units=max_units,
        )

        def f32(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                                   device=self.device)

        src = np.zeros(n)
        src[source_node] = 1.0
        C, par_l, par_j = _device_dp(
            f32(flops_ps), f32(wbytes_ps), f32(priv_ps), f32(bb), f32(eff_f),
            f32(eff_m), f32(wl.tokens_in), f32(wl.tokens_out),
            f32(wl.arrival_rate),
            torch.as_tensor(~state.trusted.astype(bool), device=self.device),
            f32(src), f32(state.link_bw), f32(state.link_lat),
        )
        return _backtrack(C.cpu().numpy(), par_l.cpu().numpy(),
                          par_j.cpu().numpy(), unit_map, L)


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

    ``device`` is where the DP runs; it defaults to ``"cuda"`` and raises
    when no card is present unless ``"cpu"`` is asked for.
    """

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
