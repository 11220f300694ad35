"""The port's control plane against the reference, on the CPU.

Discrete outputs (boundaries, assignments, decisions) must be identical.
Costs from the float64 numpy paths must be equal; the float32 device DP's
optimal cost agrees with the reference's jitted DP to float32 rounding.
"""

import numpy as np
import pytest

from repro.configs import get_bundle as jax_get_bundle
from repro.core import AdaptiveOrchestrator as JaxOrchestrator
from repro.core import CapacityProfiler as JaxProfiler
from repro.core import InProcessAgent as JaxAgent
from repro.core import JaxJointSplitter
from repro.core import NodeSample as JaxNodeSample
from repro.core import ReconfigurationBroadcast as JaxBroadcast
from repro.core import SplitRevision as JaxSplitRevision
from repro.core import Workload as JaxWorkload
from repro.core import local_search as jax_local_search
from repro.core import repair_capacity as jax_repair_capacity
from repro.core import solve_joint_dp as jax_solve_joint_dp
from repro.core import solve_placement_chain_dp as jax_chain_dp
from repro.core.cost_model import evaluate as jax_evaluate
from repro.core.cost_model import phi as jax_phi
from repro.edgesim import MECScenarioParams as JaxMEC
from repro.edgesim import base_system_state as jax_base_state
from repro_torch.configs import get_bundle
from repro_torch.core import (AdaptiveOrchestrator, CapacityProfiler,
                              GraphNode, InProcessAgent, ModelGraph,
                              NodeSample, ReconfigurationBroadcast,
                              SplitRevision, SystemState, TorchJointSplitter,
                              Workload, evaluate, local_search,
                              repair_capacity, solve_joint_dp,
                              solve_placement_chain_dp)
from repro_torch.core.cost_model import phi
from repro_torch.core.placement import Solution
from repro_torch.edgesim import MECScenarioParams, base_system_state

from test_core_solvers import _random_instance

# seeds for the instance generator of test_core_solvers.py (whose
# test_jax_dp_matches_numpy_dp draws its seeds from 0..10_000)
SEEDS = [0, 1, 2, 3, 4, 5, 6, 7, 123, 777, 2024, 4242, 5757, 7331, 9001, 10_000]


def _port(g, state, wl):
    """The same instance in the port's types (numpy arrays shared)."""
    g2 = ModelGraph(g.name, [GraphNode(u.name, u.flops, u.weight_bytes,
                                       u.act_out_bytes, u.privacy_critical)
                             for u in g.nodes])
    s2 = SystemState(state.flops_per_s, state.mem_bytes, state.background_util,
                     state.trusted, state.link_bw, state.link_lat, state.mem_bw,
                     state.names)
    return g2, s2, Workload(wl.tokens_in, wl.tokens_out, wl.arrival_rate)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_units,n_nodes", [(7, 4), (12, 6)])
def test_device_dp_matches_jax_dp_and_numpy_dp(seed, n_units, n_nodes):
    g, state, wl = _random_instance(seed, n_units=n_units, n_nodes=n_nodes)
    jx = JaxJointSplitter().solve(g, state, wl)
    ref_np = jax_solve_joint_dp(g, state, wl)
    pg, ps, pw = _port(g, state, wl)
    dev = TorchJointSplitter(device="cpu").solve(pg, ps, pw)
    mine_np = solve_joint_dp(pg, ps, pw)
    assert (dev.boundaries, dev.assignment) == (jx.boundaries, jx.assignment)
    assert dev.cost == pytest.approx(jx.cost, rel=1e-6)       # float32 rounding
    assert (mine_np.boundaries, mine_np.assignment, mine_np.cost) == \
        (ref_np.boundaries, ref_np.assignment, ref_np.cost)    # float64, same code


@pytest.mark.parametrize("seed", SEEDS[:8])
def test_dp_with_coarsening_matches_jax(seed):
    g, state, wl = _random_instance(seed, n_units=20, n_nodes=5)
    jx = JaxJointSplitter().solve(g, state, wl, max_units=6, source_node=1)
    dev = TorchJointSplitter(device="cpu").solve(*_port(g, state, wl),
                                                 max_units=6, source_node=1)
    assert (dev.boundaries, dev.assignment) == (jx.boundaries, jx.assignment)


@pytest.mark.parametrize("seed", SEEDS[:8])
def test_placement_and_local_search_match_reference(seed):
    g, state, wl = _random_instance(seed, n_units=9, n_nodes=4)
    pg, ps, pw = _port(g, state, wl)
    b = g.even_split(3).boundaries
    ref = jax_chain_dp(g, b, state, wl)
    mine = solve_placement_chain_dp(pg, b, ps, pw)
    assert (mine.boundaries, mine.assignment, mine.cost) == \
        (ref.boundaries, ref.assignment, ref.cost)
    ref_ls = jax_local_search(g, ref, state, wl, max_rounds=10)
    mine_ls = local_search(pg, mine, ps, pw, max_rounds=10)
    assert (mine_ls.boundaries, mine_ls.assignment, mine_ls.cost) == \
        (ref_ls.boundaries, ref_ls.assignment, ref_ls.cost)
    assert evaluate(pg, b, mine.assignment, ps, pw) == \
        jax_evaluate(g, b, ref.assignment, state, wl)
    assert phi(pg, b, mine.assignment, ps, pw).total == \
        jax_phi(g, b, ref.assignment, state, wl).total


def test_repair_capacity_matches_reference():
    from repro.core import GraphNode as JG, ModelGraph as JM, SystemState as JS
    from repro.core.placement import Solution as JSol

    units = [GraphNode(f"u{i}", 1e9, 4e8, 8e3) for i in range(6)]
    junits = [JG(f"u{i}", 1e9, 4e8, 8e3) for i in range(6)]
    kw = dict(flops_per_s=np.array([1e13, 1e13, 1e13]),
              mem_bytes=np.array([1e9, 5e9, 5e9]),
              background_util=np.zeros(3), trusted=np.ones(3, bool),
              link_bw=np.full((3, 3), 1e8), link_lat=np.zeros((3, 3)))
    wl = Workload(32, 8, 1.0)
    start = ((0, 2, 4, 6), (0, 0, 0))
    mine = repair_capacity(ModelGraph("g", units), Solution(*start, 0.0),
                           SystemState(**kw), wl)
    ref = jax_repair_capacity(JM("g", junits), JSol(*start, 0.0), JS(**kw),
                              JaxWorkload(32, 8, 1.0))
    assert (mine.boundaries, mine.assignment, mine.cost) == \
        (ref.boundaries, ref.assignment, ref.cost)


def _orchestrators(backhaul_mbps, wl_args, reduced=True):
    jg = jax_get_bundle("llama3-8b", reduced=reduced).model_graph()
    tg = get_bundle("llama3-8b", reduced=reduced).model_graph()
    jstate = jax_base_state(JaxMEC(backhaul_mbps=backhaul_mbps))
    tstate = base_system_state(MECScenarioParams(backhaul_mbps=backhaul_mbps))
    jp, tp = JaxProfiler(base_state=jstate), CapacityProfiler(base_state=tstate)
    jo = JaxOrchestrator(
        graph=jg, profiler=jp,
        broadcast=JaxBroadcast([JaxAgent(i) for i in range(4)]),
        workload=JaxWorkload(*wl_args), splitter=JaxSplitRevision())
    to = AdaptiveOrchestrator(
        graph=tg, profiler=tp,
        broadcast=ReconfigurationBroadcast([InProcessAgent(i) for i in range(4)]),
        workload=Workload(*wl_args), splitter=SplitRevision(device="cpu"))
    return (jo, jp, jstate, jg), (to, tp, tstate, tg)


def _same(jd, td):
    assert td.kind.value == jd.kind.value
    assert td.reasons == jd.reasons
    assert td.predicted_latency_s == jd.predicted_latency_s
    jc, tc = jd.config, td.config
    assert (tc.version, tc.boundaries, tc.assignment) == \
        (jc.version, jc.boundaries, jc.assignment)


@pytest.mark.parametrize("reduced", [True, False])
def test_quickstart_decisions_identical(reduced):
    """examples/quickstart.py steps 3-4 through both packages."""
    (jo, jp, jstate, jg), (to, tp, tstate, tg) = _orchestrators(
        20.0, (56, 8, 4.0), reduced)
    jcfg = jo.deploy_initial(jg.even_split(3).boundaries, (0, 3, 0))
    tcfg = to.deploy_initial(tg.even_split(3).boundaries, (0, 3, 0))
    assert (tcfg.boundaries, tcfg.assignment) == (jcfg.boundaries, jcfg.assignment)
    jp.observe_latency(0.450)
    tp.observe_latency(0.450)
    jp.observe_links(jstate.link_bw)
    tp.observe_links(tstate.link_bw)
    _same(jo.step(now=100.0), to.step(now=100.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_stream_identical_under_fluctuating_load(seed):
    """40 monitoring cycles of seeded node load, latency and link samples:
    every decision (kind, reasons, config, predicted latency) identical."""
    (jo, jp, jstate, jg), (to, tp, tstate, tg) = _orchestrators(
        50.0, (128, 16, 2.0), reduced=False)
    L = len(jg)
    jo.deploy_initial((0, L // 3, 2 * L // 3, L), (0, 3, 0))
    to.deploy_initial((0, L // 3, 2 * L // 3, L), (0, 3, 0))
    rng = np.random.default_rng(seed)
    for t in range(40):
        for node in range(4):
            u = float(rng.uniform(0.05, 0.95))
            jp.observe_node(JaxNodeSample(node, u, u * 0.8))
            tp.observe_node(NodeSample(node, u, u * 0.8))
        bw = jstate.link_bw * rng.uniform(0.2, 1.2, jstate.link_bw.shape)
        jp.observe_links(bw)
        tp.observe_links(bw)
        lat = float(rng.uniform(0.05, 0.5))
        jp.observe_latency(lat)
        tp.observe_latency(lat)
        _same(jo.step(now=10.0 * t), to.step(now=10.0 * t))


def test_split_revision_requires_cuda_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SplitRevision()
