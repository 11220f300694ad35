"""Placement solvers: given a split scheme, choose the node per segment.

Implements the paper's placement sub-problem (the binary matrix x of §III-B
restricted to constraint (3): one node per segment).

* :func:`solve_placement_chain_dp` — exact for the chain-latency surrogate
  (per-segment exec + boundary transfers + privacy mask), O(k·n²).
* :func:`greedy_placement` — segments left to right, each on the node
  that minimizes the full Φ so far: the seed of :func:`local_search`.
* :func:`local_search` — refines the FULL Φ (queueing feedback, utilization
  imbalance, memory penalties) with reassign / boundary-shift / merge / split
  moves.  The DP surrogate is additive by construction; Φ's queueing and
  imbalance terms are not, hence this refinement stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .cost_model import _EPS, _RHO_CAP, SystemState, Workload, evaluate
from .graph import ModelGraph, validate_boundaries

__all__ = [
    "surrogate_cost",
    "solve_placement_chain_dp",
    "greedy_placement",
    "local_search",
    "repair_capacity",
    "fixed_point_reference",
    "select_candidate_nodes",
    "restrict_state",
    "Solution",
]

_INF = float("inf")
_BIG = 1e30


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
    mem_residual: np.ndarray | None = None,
) -> Solution:
    """Exact chain DP on the additive surrogate (Eq. 7 migration).

    ``mem_residual`` (n,) adds the Eq. 4 single-segment mask: a node whose
    residual memory cannot hold a segment's weights alone costs +inf for
    that segment, exactly like the privacy mask.  This is the pinned scalar
    reference for the memory-masked batched solvers
    (:class:`repro_torch.core.fleet_eval.BatchedMigrationSolver` and the
    fused migrate program); multi-segment accumulation on one node is outside
    the DP state and handled by the repair pass.
    """
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
        if mem_residual is not None:
            exec_cost[j][sw > np.asarray(mem_residual, dtype=float)] = _INF

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
# greedy + local search on the FULL Φ
# --------------------------------------------------------------------------- #
def greedy_placement(
    graph: ModelGraph,
    boundaries: Sequence[int],
    state: SystemState,
    wl: Workload,
) -> Solution:
    """Assign segments left→right to the marginal-cost-minimizing node (the
    segments not yet placed ride on the same node; ties keep the first)."""
    n = state.num_nodes
    assignment: list[int] = []
    for j in range(len(boundaries) - 1):
        best, best_c = 0, _INF
        for i in range(n):
            trial = assignment + [i] + [i] * (len(boundaries) - 2 - j)
            c = evaluate(graph, boundaries, trial, state, wl)
            if c < best_c:
                best, best_c = i, c
        assignment.append(best)
    cost = evaluate(graph, boundaries, assignment, state, wl)
    return Solution(tuple(boundaries), tuple(assignment), cost)


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


# --------------------------------------------------------------------------- #
# pinned scalar reference for the device fixed-point joint reconfiguration
# --------------------------------------------------------------------------- #
def fixed_point_reference(
    seg_flops: np.ndarray,      # (B, K) float64
    seg_w: np.ndarray,          # (B, K) float64
    seg_priv: np.ndarray,       # (B, K) bool
    seg_node0: np.ndarray,      # (B, K) int64 — cycle-start joint assignment
    valid: np.ndarray,          # (B, K) bool
    xbytes: np.ndarray,         # (B, K) float64
    n_segs: np.ndarray,         # (B,) int64
    t_in: np.ndarray,           # (B,) float64
    t_out: np.ndarray,          # (B,) float64
    lam: np.ndarray,            # (B,) float64
    source: np.ndarray,         # (B,) int64
    input_bytes_tok: np.ndarray,  # (B,) float64
    active: np.ndarray,         # (B,) bool
    trig: np.ndarray,           # (B,) bool — rows allowed to move
    force: np.ndarray,          # (B,) bool — storm rows: any feasible change
    slo: np.ndarray,            # (B,) float64 — per-row latency SLO
    base_bg: np.ndarray,        # (n,) fold base background util
    base_lbw: np.ndarray,       # (n, n) fold base link bandwidth (finite)
    link_bw: np.ndarray,        # (n, n) instantaneous link bandwidth (finite)
    link_lat: np.ndarray,       # (n, n) link latency (finite)
    flops_per_s: np.ndarray,    # (n,)
    mem_bw: np.ndarray,         # (n,)
    trusted: np.ndarray,        # (n,) bool
    mem_bytes: np.ndarray,      # (n,)
    *,
    alpha: float = 1.0,
    beta: float = 0.05,
    gamma: float = 1000.0,
    mem_penalty: float = 1e3,
    bw_floor: float = 0.05,
    imp_frac: float = 0.10,
    max_sweeps: int = 8,
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray, np.ndarray, bool]:
    """Sequential-commit reference for the device red/black fixed point.

    The red/black schedule IS the sequential consistency: within a
    half-sweep only one colour's rows may accept, and the next half-sweep
    re-prices every row against residuals that include those accepts — so
    each accepted move was priced against a state containing every earlier
    committed move, exactly as if the rows had committed one at a time.
    This function replays that schedule op for op in numpy (same DP, same
    greedy repair, same accept predicate, same joint Eq. 4 guard) and is
    the pinned oracle for :func:`repro_torch.core.fleet_eval._fixed_point`:
    the device program must reproduce these INTEGER assignments bit-exactly
    (``tests/test_torch_fleet_eval.py``); latencies agree to float64 rounding.

    Returns ``(assign (B, K), lat (B,), sweeps, moved (B,),
    moved_pre (B,), aborted)``.
    """
    seg_node0 = np.asarray(seg_node0, dtype=np.int64)
    B, K = seg_flops.shape
    n = int(np.asarray(mem_bytes).shape[0])
    bidx = np.arange(B)[:, None]
    rows_flat = np.repeat(np.arange(B), K)
    av = valid & active[:, None]
    w_av = np.where(av, seg_w, 0.0)
    total_tok = t_in + t_out
    colour = (np.arange(B) % 2) == 0

    def scatter2(idx, vals):
        out = np.zeros((B, n))
        np.add.at(out, (rows_flat, idx.ravel()), vals.ravel())
        return out

    def eff(a):
        f_raw = np.maximum(flops_per_s[a], _EPS)
        m_raw = np.maximum(mem_bw[a], _EPS)
        ft = seg_flops / f_raw
        svc = t_in[:, None] * ft + t_out[:, None] * np.maximum(
            ft, seg_w / m_raw
        )
        svc = np.where(av, svc, 0.0)
        node_r = scatter2(a, lam[:, None] * svc)
        wb = scatter2(a, w_av)
        prev = np.concatenate([source[:, None], a[:, :-1]], axis=1)
        cross = (prev != a) & av & (xbytes > 0)
        lrho = np.where(
            cross,
            lam[:, None] * xbytes * total_tok[:, None]
            / np.maximum(link_bw[prev, a], _EPS),
            0.0,
        )
        link_r = np.zeros((B, n, n))
        np.add.at(link_r, (rows_flat, prev.ravel(), a.ravel()), lrho.ravel())
        tot_node, tot_link, tot_w = node_r.sum(0), link_r.sum(0), wb.sum(0)
        bg = np.clip(
            base_bg[None, :] + (tot_node[None, :] - node_r), 0.0, 0.99
        )
        lbw = base_lbw[None] * np.clip(
            1.0 - (tot_link[None] - link_r), bw_floor, 1.0
        )
        mem = np.maximum(0.0, mem_bytes[None, :] - (tot_w[None, :] - wb))
        return bg, lbw, mem, wb

    def lat_of(a, bg, lbw, mem):
        derate = np.maximum(_EPS, 1.0 - bg)
        f_eff = np.maximum(flops_per_s[None, :] * derate, _EPS)
        m_eff = np.maximum(mem_bw[None, :] * derate, _EPS)
        f_seg = np.take_along_axis(f_eff, a, axis=1)
        m_seg = np.take_along_axis(m_eff, a, axis=1)
        ft = seg_flops / f_seg
        svc = t_in[:, None] * ft + t_out[:, None] * np.maximum(
            ft, seg_w / m_seg
        )
        svc = np.where(valid, svc, 0.0)
        rho_q = scatter2(a, lam[:, None] * svc)
        t_proc = svc.sum(axis=1)
        r = np.minimum(np.take_along_axis(rho_q, a, axis=1), _RHO_CAP)
        t_queue = (svc * r / (1.0 - r)).sum(axis=1)
        prev = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
        has_prev = np.arange(K)[None, :] > 0
        cross = (prev != a) & valid & has_prev
        bw = lbw[bidx, prev, a]
        lt = link_lat[prev, a]
        bytes_ = xbytes * total_tok[:, None]
        t_tx = np.where(
            cross, bytes_ / np.maximum(bw, _EPS) + lt, 0.0
        ).sum(axis=1)
        return t_proc + t_queue + t_tx

    def surrogate(bg, lbw, mem):
        derate = np.maximum(_EPS, 1.0 - bg)
        f_eff = np.maximum(flops_per_s[None, :] * derate, _EPS)
        m_eff = np.maximum(mem_bw[None, :] * derate, _EPS)
        ft = seg_flops[:, :, None] / f_eff[:, None, :]
        svc = (t_in[:, None, None] * ft
               + t_out[:, None, None]
               * np.maximum(ft, seg_w[:, :, None] / m_eff[:, None, :]))
        load = np.minimum(lam[:, None, None] * svc, 0.9)
        exec_cost = svc / (1.0 - load)
        exec_cost = np.where(
            seg_priv[:, :, None] & (~trusted)[None, None, :], _BIG, exec_cost
        )
        exec_cost = np.where(
            seg_w[:, :, None] > mem[:, None, :], _BIG, exec_cost
        )
        tt = total_tok[:, None, None, None]
        xf = (xbytes[:, :, None, None] * tt
              / np.maximum(lbw[:, None], _EPS)) + link_lat[None, None]
        xf = np.where(np.eye(n, dtype=bool)[None, None], 0.0, xf)
        src_bytes = input_bytes_tok * total_tok
        src = (src_bytes[:, None]
               / np.maximum(lbw[np.arange(B), source], _EPS)
               + link_lat[source])
        src = np.where(source[:, None] == np.arange(n)[None, :], 0.0, src)
        return exec_cost, xf, src

    def dp_backtrack(exec_cost, xf, src):
        cand = np.empty((B, K), dtype=np.int64)
        for b in range(B):
            k = int(n_segs[b])
            C = exec_cost[b, 0] + src[b]
            parents = np.empty((max(K - 1, 0), n), dtype=np.int64)
            for j in range(1, K):
                if j < k:
                    c2 = C[:, None] + xf[b, j] + exec_cost[b, j][None, :]
                    parents[j - 1] = np.argmin(c2, axis=0)
                    C = np.min(c2, axis=0)
                else:
                    parents[j - 1] = np.arange(n)
            j0 = int(np.argmin(C))
            j = j0
            ys = []
            for step in range(K - 2, -1, -1):
                if step <= k - 2:
                    j = int(parents[step, j])
                ys.append(j)
            cand[b] = np.array(ys[::-1] + [j0], dtype=np.int64)
        return cand

    def repair_np(a, mem, exec_cost, xf, src):
        a = a.copy()
        idx = np.arange(n)
        for b in range(B):
            ab = a[b]
            wv = np.where(valid[b], seg_w[b], 0.0)
            for _ in range(K):
                used = np.zeros(n)
                np.add.at(used, ab, wv)
                over = np.maximum(0.0, used - mem[b])
                bad = int(np.argmax(over))
                if not over[bad] > 0.0:
                    continue
                fits = ((used[None, :] + seg_w[b][:, None] <= mem[b][None, :])
                        & (idx[None, :] != bad))
                movable = valid[b] & (ab == bad) & fits.any(axis=1)
                if not movable.any():
                    continue
                k_star = int(np.argmax(np.where(movable, seg_w[b], -1.0)))
                prev = ab[max(k_star - 1, 0)]
                in_c = src[b] if k_star == 0 else xf[b, k_star, prev]
                nxt_k = min(k_star + 1, K - 1)
                out_c = (xf[b, nxt_k, :, ab[nxt_k]]
                         if k_star + 1 < int(n_segs[b]) else 0.0)
                cost = exec_cost[b, k_star] + in_c + out_c
                ab[k_star] = int(np.argmin(np.where(fits[k_star], cost,
                                                    np.inf)))
        return a

    def half(a, colour_mask):
        bg, lbw, mem, wb = eff(a)
        exec_cost, xf, src = surrogate(bg, lbw, mem)
        cand = dp_backtrack(exec_cost, xf, src)
        cand = repair_np(cand, mem, exec_cost, xf, src)
        cand = np.where(valid, cand, a)
        cur_lat = lat_of(a, bg, lbw, mem)
        cand_lat = lat_of(cand, bg, lbw, mem)
        cand_over = np.any(scatter2(cand, w_av) > mem, axis=1)
        cur_over = np.any(wb > mem, axis=1)
        changed = np.any(cand != a, axis=1)
        cur_breach = np.maximum(0.0, cur_lat - slo)
        cand_breach = np.maximum(0.0, cand_lat - slo)
        better = cand_lat < cur_lat * (1.0 - imp_frac)
        gain = (cand_breach < cur_breach) | (
            (cand_breach == cur_breach) & better
        )
        escape = cur_over & ~cand_over
        accept = (trig & active & colour_mask & changed & ~cand_over
                  & (gain | escape | force))
        a_new = np.where(accept[:, None], cand, a)
        # fleet-global monotonicity (mirrors the device half-sweep): the
        # colour's moves stand only if total predicted breach-seconds under
        # the residuals they induce does not increase, or they shrink total
        # Eq. 4 overflow (storm escapes land even at a latency cost)
        bg2, lbw2, mem2, _ = eff(a_new)
        new_lat = lat_of(a_new, bg2, lbw2, mem2)
        breach_cur = float(np.where(
            active, np.maximum(0.0, cur_lat - slo), 0.0
        ).sum())
        breach_new = float(np.where(
            active, np.maximum(0.0, new_lat - slo), 0.0
        ).sum())

        def tot_over(ax):
            used = scatter2(ax, w_av)
            return np.maximum(0.0, used.sum(axis=0) - mem_bytes).sum()

        over_cur, over_new = tot_over(a), tot_over(a_new)
        # lexicographic descent on (total overflow, total breach) — mirrors
        # the device half-sweep exactly; see _make_fixed_point
        ok = (over_new <= over_cur) and (
            (breach_new <= breach_cur + 1e-9) or (over_new < over_cur)
        )
        if not ok:
            return a, False
        return a_new, bool(accept.any())

    a = seg_node0.copy()
    moved_pre = np.zeros(B, dtype=bool)
    sweeps = 0
    moved_last = True
    while sweeps < max_sweeps and moved_last:
        a1, m1 = half(a, colour)
        a2, m2 = half(a1, ~colour)
        moved_pre |= np.any(a2 != a, axis=1)
        a = a2
        moved_last = m1 or m2
        sweeps += 1

    def total_over(ax):
        used = scatter2(ax, w_av)
        return np.maximum(0.0, used.sum(axis=0) - mem_bytes).sum()

    aborted = bool(total_over(a) > total_over(seg_node0))
    if aborted:
        a = seg_node0.copy()
    moved = moved_pre & np.any(a != seg_node0, axis=1)
    bg, lbw, mem, _ = eff(a)
    return a, lat_of(a, bg, lbw, mem), sweeps, moved, moved_pre, aborted
