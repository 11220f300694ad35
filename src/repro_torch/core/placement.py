"""Placement solvers: given a split scheme, choose the node per segment.

Implements the paper's placement sub-problem (the binary matrix x of §III-B
restricted to constraint (3): one node per segment).

* :func:`solve_placement_chain_dp` — exact for the chain-latency surrogate
  (per-segment exec + boundary transfers + privacy mask), O(k·n²).
* :func:`local_search` — refines the FULL Φ (queueing feedback, utilization
  imbalance, memory penalties) with reassign / boundary-shift / merge / split
  moves.  The DP surrogate is additive by construction; Φ's queueing and
  imbalance terms are not, hence this refinement stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .cost_model import SystemState, Workload, evaluate
from .graph import ModelGraph, validate_boundaries

__all__ = [
    "surrogate_cost",
    "solve_placement_chain_dp",
    "local_search",
    "repair_capacity",
    "select_candidate_nodes",
    "restrict_state",
    "Solution",
]

_INF = float("inf")


@dataclass(frozen=True)
class Solution:
    boundaries: tuple[int, ...]
    assignment: tuple[int, ...]
    cost: float


def select_candidate_nodes(
    state: SystemState,
    *,
    k: int = 12,
    source_node: int = 0,
    min_trusted: int = 2,
) -> np.ndarray:
    """Prune a large fleet to the k most promising nodes for the DP.

    At 1000+-node scale the joint DP cannot consider every node (O(L²·n²));
    a real orchestrator short-lists by locality and residual capacity.  Score
    = residual FLOP/s ⊕ link quality to the source; the source node and the
    best trusted nodes are always kept so privacy constraints stay feasible.
    Returns sorted original node indices.
    """
    n = state.num_nodes
    if n <= k:
        return np.arange(n)
    residual = state.flops_per_s * np.maximum(0.0, 1.0 - state.background_util)
    link = state.link_bw[source_node].copy()
    finite = link[np.isfinite(link)]
    link[~np.isfinite(link)] = finite.max() if finite.size else 1.0
    score = residual * (1.0 + link / max(link.max(), 1e-9))
    keep = set([source_node])
    trusted_ids = np.where(state.trusted)[0]
    for t in trusted_ids[np.argsort(-score[trusted_ids])][:min_trusted]:
        keep.add(int(t))
    for i in np.argsort(-score):
        if len(keep) >= k:
            break
        keep.add(int(i))
    return np.array(sorted(keep), dtype=np.int64)


def restrict_state(state: SystemState, idx: np.ndarray) -> SystemState:
    """SystemState restricted to ``idx`` (for candidate-pruned solves)."""
    return SystemState(
        flops_per_s=state.flops_per_s[idx],
        mem_bytes=state.mem_bytes[idx],
        background_util=state.background_util[idx],
        trusted=state.trusted[idx],
        link_bw=state.link_bw[np.ix_(idx, idx)],
        link_lat=state.link_lat[np.ix_(idx, idx)],
        mem_bw=state.mem_bw[idx],
        names=tuple(state.names[i] for i in idx),
    )


# --------------------------------------------------------------------------- #
# surrogate (additive) cost — shared by DP solvers and their brute-force tests
# --------------------------------------------------------------------------- #
def surrogate_cost(
    graph: ModelGraph,
    boundaries: Sequence[int],
    assignment: Sequence[int],
    state: SystemState,
    wl: Workload,
    *,
    source_node: int = 0,
    input_bytes_per_token: float = 4.0,
) -> float:
    """Additive chain cost: derated exec + transfers; +inf on privacy breach."""
    from .cost_model import mm1_response_factor, segment_service_time

    tokens = wl.total_tokens
    total = 0.0
    prev = source_node
    for j, (lo, hi) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        node = assignment[j]
        if graph.segment_has_private(lo, hi) and not state.trusted[node]:
            return _INF
        svc = segment_service_time(
            graph.segment_flops(lo, hi), graph.segment_weight_bytes(lo, hi),
            node, state, wl,
        )
        total += svc * mm1_response_factor(wl.arrival_rate * svc)
        bytes_per_tok = (
            input_bytes_per_token if j == 0 else graph.boundary_act_bytes(boundaries[j])
        )
        if node != prev:
            total += bytes_per_tok * tokens / max(state.link_bw[prev, node], 1e-12)
            total += state.link_lat[prev, node]
        prev = node
    return total


# --------------------------------------------------------------------------- #
# chain DP over (segment, node) — exact on the surrogate
# --------------------------------------------------------------------------- #
def solve_placement_chain_dp(
    graph: ModelGraph,
    boundaries: Sequence[int],
    state: SystemState,
    wl: Workload,
    *,
    source_node: int = 0,
    input_bytes_per_token: float = 4.0,
) -> Solution:
    """Exact chain DP on the additive surrogate (Eq. 7 migration)."""
    validate_boundaries(boundaries, len(graph))
    n = state.num_nodes
    segs = list(zip(boundaries[:-1], boundaries[1:]))
    k = len(segs)
    tokens = wl.total_tokens
    derate = np.maximum(1e-12, 1.0 - state.background_util)
    eff_f = state.flops_per_s * derate
    eff_m = state.mem_bw * derate

    # exec[j, i]: segment j on node i — prefill compute + roofline decode,
    # inflated by the per-segment M/M/1 response factor (+inf on privacy breach)
    exec_cost = np.empty((k, n))
    for j, (lo, hi) in enumerate(segs):
        sf, sw = graph.segment_flops(lo, hi), graph.segment_weight_bytes(lo, hi)
        svc = wl.tokens_in * sf / eff_f + wl.tokens_out * np.maximum(
            sf / eff_f, sw / eff_m
        )
        load = np.minimum(wl.arrival_rate * svc, 0.9)
        exec_cost[j] = svc / (1.0 - load)
        if graph.segment_has_private(lo, hi):
            exec_cost[j][~state.trusted] = _INF

    # xfer[i_prev, i]: boundary act bytes over link (0 on diagonal)
    def xfer(bytes_per_tok: float) -> np.ndarray:
        t = bytes_per_tok * tokens / np.maximum(state.link_bw, 1e-12) + state.link_lat
        np.fill_diagonal(t, 0.0)
        return t

    C = exec_cost[0] + xfer(input_bytes_per_token)[source_node]
    parents = np.zeros((k, n), dtype=np.int64)
    for j in range(1, k):
        t = xfer(graph.boundary_act_bytes(boundaries[j]))
        cand = C[:, None] + t + exec_cost[j][None, :]  # (prev, cur)
        parents[j] = np.argmin(cand, axis=0)
        C = np.min(cand, axis=0)

    best_last = int(np.argmin(C))
    assignment = [best_last]
    for j in range(k - 1, 0, -1):
        assignment.append(int(parents[j][assignment[-1]]))
    assignment.reverse()
    return Solution(tuple(boundaries), tuple(assignment), float(C[best_last]))


# --------------------------------------------------------------------------- #
# local search on the FULL Φ
# --------------------------------------------------------------------------- #
def _boundary_moves(boundaries: tuple[int, ...], L: int) -> list[tuple[int, ...]]:
    out = []
    b = list(boundaries)
    for j in range(1, len(b) - 1):
        for d in (-4, -2, -1, 1, 2, 4):
            nb = b[:]
            nb[j] += d
            if nb[j - 1] < nb[j] < nb[j + 1]:
                out.append(tuple(nb))
    return out


def local_search(
    graph: ModelGraph,
    start: Solution,
    state: SystemState,
    wl: Workload,
    *,
    max_rounds: int = 40,
    allow_resplit: bool = True,
) -> Solution:
    """Hill-climb Φ with reassign / boundary-shift / merge / split moves."""
    L = len(graph)
    n = state.num_nodes
    cur_b, cur_a = list(start.boundaries), list(start.assignment)
    cur_c = evaluate(graph, cur_b, cur_a, state, wl)

    for _ in range(max_rounds):
        improved = False
        # move 1: reassign one segment
        for j in range(len(cur_a)):
            for i in range(n):
                if i == cur_a[j]:
                    continue
                trial = cur_a[:]
                trial[j] = i
                c = evaluate(graph, cur_b, trial, state, wl)
                if c < cur_c - 1e-12:
                    cur_a, cur_c, improved = trial, c, True
        if allow_resplit:
            # move 2: shift a boundary
            for nb in _boundary_moves(tuple(cur_b), L):
                c = evaluate(graph, nb, cur_a, state, wl)
                if c < cur_c - 1e-12:
                    cur_b, cur_c, improved = list(nb), c, True
            # move 3: merge adjacent segments on the cheaper node
            if len(cur_b) > 2:
                merged = False
                for j in range(len(cur_a) - 1):
                    nb = cur_b[: j + 1] + cur_b[j + 2 :]
                    for keep in (cur_a[j], cur_a[j + 1]):
                        na = cur_a[:j] + [keep] + cur_a[j + 2 :]
                        c = evaluate(graph, nb, na, state, wl)
                        if c < cur_c - 1e-12:
                            cur_b, cur_a, cur_c, improved = nb, na, c, True
                            merged = True
                            break
                    if merged:  # lists changed length — restart the scan
                        break
            # move 4: split the largest segment at its midpoint
            sizes = [cur_b[j + 1] - cur_b[j] for j in range(len(cur_a))]
            j = int(np.argmax(sizes))
            if sizes[j] >= 2:
                mid = (cur_b[j] + cur_b[j + 1]) // 2
                nb = cur_b[: j + 1] + [mid] + cur_b[j + 1 :]
                for i in range(n):
                    na = cur_a[: j + 1] + [i] + cur_a[j + 1 :]
                    c = evaluate(graph, nb, na, state, wl)
                    if c < cur_c - 1e-12:
                        cur_b, cur_a, cur_c, improved = nb, na, c, True
                        break
        if not improved:
            break
    return Solution(tuple(cur_b), tuple(cur_a), cur_c)


def repair_capacity(
    graph: ModelGraph,
    sol: Solution,
    state: SystemState,
    wl: Workload,
    *,
    max_moves: int = 32,
) -> Solution:
    """Greedy repair of Eq. (4) violations: move segments off overfull nodes.

    Per-node residuals are computed once and updated incrementally per move,
    so the destination feasibility check is O(1).
    """
    b, a = list(sol.boundaries), list(sol.assignment)
    seg_w = [graph.segment_weight_bytes(lo, hi)
             for lo, hi in zip(b[:-1], b[1:])]
    mem = np.asarray(state.mem_bytes, dtype=np.float64)
    used = np.zeros(state.num_nodes)
    for j, node in enumerate(a):
        used[node] += seg_w[j]
    for _ in range(max_moves):
        over = np.maximum(0.0, used - mem)
        if not over.any():
            break
        bad = int(np.argmax(over))
        # largest segment on the overfull node
        seg_ids = [j for j, node in enumerate(a) if node == bad]
        seg_ids.sort(key=lambda j: -seg_w[j])
        moved = False
        for j in seg_ids:
            best, best_c = None, _INF
            for i in range(state.num_nodes):
                # destination must stay within capacity after the move
                if i == bad or used[i] + seg_w[j] > mem[i]:
                    continue
                trial = a[:]
                trial[j] = i
                c = evaluate(graph, b, trial, state, wl)
                if c < best_c:
                    best, best_c = i, c
            if best is not None:
                used[bad] -= seg_w[j]
                used[best] += seg_w[j]
                a[j] = best
                moved = True
                break
        if not moved:
            break  # infeasible under current split; SR must re-split
    return Solution(tuple(b), tuple(a), evaluate(graph, b, a, state, wl))
