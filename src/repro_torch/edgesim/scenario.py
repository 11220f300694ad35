"""§IV scenario builder: 5G-MEC urban, 3 MEC nodes + cloud, Llama3-8B.

Topology (paper §IV-a):

    node 0  home MEC   (A100-40GB class, trusted; receives requests)
    node 1  MEC-2      (A100-40GB class, trusted; edge-to-edge link)
    node 2  MEC-3      (A100-40GB class, trusted; edge-to-edge link)
    node 3  cloud      (multi-GPU pool, UNtrusted; reached over the backhaul)

The static baseline is the paper's `{S1, S2, S3}` split: S1 (embedding + first
blocks) and S3 (last blocks + head) on the home MEC for privacy, the heavy S2
offloaded to the cloud.  The adaptive orchestrator may migrate S2 to the other
MECs or re-split when triggers fire.  Backhaul bandwidth is swept over
{20, 50, 100, 200} Mb/s; the home MEC carries a fluctuating background load
with periodic saturation events (other tenants of the base station).

Beyond the paper: :func:`build_fleet_scenario` instantiates the SAME topology
in multi-session mode — Poisson session churn with heterogeneous model
configs drawn from ``repro_torch.configs`` (rendered to analytic
:class:`ModelGraph` chains by the bundle API's ``model_graph()``), a
:class:`~repro_torch.core.fleet.FleetOrchestrator` arbitrating the shared
fleet capacity, and a
:class:`~repro_torch.core.admission.FleetAdmissionController` pricing each
arrival's achievable latency against its QoS class before it may join
(disable with ``FleetSimConfig(admission=False)`` for blind admission).
:func:`regional_system_state` and :func:`build_regional_orchestrator`
replicate the cluster as R MEC regions under one region-sharded control
plane.

Every builder takes ``device`` (default ``"cuda"``, raising without a card)
and builds each splitter, orchestrator and forecaster on it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.admission import FleetAdmissionController
from ..core.broadcast import InProcessAgent, ReconfigurationBroadcast
from ..core.cost_model import CostWeights, SystemState, Workload
from ..core.fleet import FleetOrchestrator, ShardedFleetOrchestrator
from ..core.graph import ModelGraph, make_transformer_graph
from ..core.orchestrator import AdaptiveOrchestrator
from ..core.profiling import CapacityProfiler
from ..core.splitter import SplitRevision
from ..core.triggers import Thresholds
from .simulator import EdgeSimulator, FleetSimConfig, FleetSimulator, SimConfig
from .traces import Trace, constant, ou_process, square_wave

__all__ = [
    "MBPS", "MECScenarioParams", "llama3_8b_graph", "build_mec_scenario",
    "static_baseline_split", "FleetScenarioParams", "build_fleet_scenario",
    "fleet_model_catalog", "mec_traces", "spike_onsets", "base_system_state",
    "regional_system_state", "regional_traces", "build_regional_orchestrator",
]

MBPS = 1e6 / 8.0  # bytes/s per Mb/s


def llama3_8b_graph() -> ModelGraph:
    """Llama3-8B (paper's model [27]): 32L, d=4096, 32H kv=8, ff=14336."""
    d, ff, vocab = 4096, 14336, 128256
    hd, kv = 128, 8
    attn = d * d + 2 * d * kv * hd + d * d            # q, k+v, o
    mlp = 3 * d * ff                                   # gate, up, down
    block_params = attn + mlp
    return make_transformer_graph(
        name="llama3-8b",
        num_layers=32,
        d_model=d,
        flops_per_layer_token=2.0 * block_params,
        weight_bytes_per_layer=2.0 * block_params,     # bf16
        embed_weight_bytes=2.0 * vocab * d,
        head_weight_bytes=2.0 * vocab * d,
        head_flops_token=2.0 * vocab * d,
    )


# archs spanning ~3B → ~33B: small models fit one MEC, the 33B forces cloud
# offload of its trunk, llama/gemma sit in between, and qwen3-moe exercises
# expert-aware pricing (active FLOPs << resident bytes)
_FLEET_ARCHS = ("stablelm-3b", "llama3-8b", "gemma2-9b",
                "qwen3-moe-30b-a3b", "deepseek-coder-33b")


def fleet_model_catalog(archs: tuple[str, ...] = _FLEET_ARCHS):
    """(arch_id, ModelGraph) pairs for the multi-session scenario.

    Graphs come from the bundle API's analytic ``model_graph()`` — the same
    accounting the serving layer uses (MoE-aware: FLOPs priced on active
    params, bytes on resident params), so fleet pricing can never drift from
    the model-side source of truth.
    """
    from ..configs import get_bundle

    return [(a, get_bundle(a).model_graph()) for a in archs]


@dataclass(frozen=True)
class MECScenarioParams:
    """Calibrated so the STATIC baseline reproduces Table II's static column
    ({~550, ~310, ~230, ~190} ms over the backhaul sweep); the adaptive column
    then emerges from the orchestrator with paper-default triggers."""

    backhaul_mbps: float = 50.0
    arrival_rate: float = 4.0            # requests/s entering the home MEC
    tokens_in: int = 56                  # prompt tokens crossing boundaries
    tokens_out: int = 8                  # decoded tokens per request
    # A100-40GB class MEC nodes (effective serving rates, not peaks)
    mec_flops: float = 140e12            # ~45% MFU of 312 TF bf16
    mec_membw: float = 1.4e12            # ~90% of 1.55 TB/s HBM2e
    mec_mem: float = 40e9
    # cloud pool: several accelerators behind the backhaul
    cloud_flops: float = 600e12
    cloud_membw: float = 5.0e12
    cloud_mem: float = 320e9
    edge_to_edge_mbps: float = 1000.0    # metro fiber between MEC sites
    base_latency_s: float = 0.004        # propagation per hop
    home_util_base: float = 0.30
    home_util_spike: float = 0.70        # saturation events on the home MEC
    spike_period_s: float = 40.0
    spike_duty: float = 0.25
    neighbor_util: float = 0.25
    cloud_util: float = 0.10
    duration_s: float = 120.0
    seed: int = 0


def base_system_state(p: MECScenarioParams) -> SystemState:
    n = 4
    bw = np.full((n, n), p.edge_to_edge_mbps * MBPS)
    bw[:, 3] = bw[3, :] = p.backhaul_mbps * MBPS     # backhaul to/from cloud
    np.fill_diagonal(bw, np.inf)
    lat = np.full((n, n), p.base_latency_s)
    lat[:, 3] = lat[3, :] = 4 * p.base_latency_s      # cloud is farther
    np.fill_diagonal(lat, 0.0)
    return SystemState(
        flops_per_s=np.array([p.mec_flops] * 3 + [p.cloud_flops]),
        mem_bytes=np.array([p.mec_mem] * 3 + [p.cloud_mem]),
        background_util=np.array(
            [p.home_util_base, p.neighbor_util, p.neighbor_util, p.cloud_util]
        ),
        trusted=np.array([True, True, True, False]),
        link_bw=bw,
        link_lat=lat,
        mem_bw=np.array([p.mec_membw] * 3 + [p.cloud_membw]),
        names=("home-mec", "mec-2", "mec-3", "cloud"),
    )


def static_baseline_split(graph: ModelGraph) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Paper §III-C(1): S1, S3 local for privacy; heavy S2 on the cloud."""
    L = len(graph)
    boundaries = (0, 5, L - 5, L)       # embed+4 blocks | 24 blocks | 4 blocks+head
    assignment = (0, 3, 0)              # home, cloud, home
    return boundaries, assignment


def mec_traces(
    p: MECScenarioParams, horizon_s: float
) -> tuple[dict[int, Trace], dict[tuple[int, int], Trace]]:
    """§IV environment dynamics, shared by the single-session and fleet
    builders: home-MEC saturation square wave, OU-fluctuating neighbors,
    and a backhaul that wanders ±20 % around the swept value."""
    util_traces: dict[int, Trace] = {
        0: Trace(square_wave(p.home_util_base, p.home_util_spike,
                             p.spike_period_s, p.spike_duty), 0.0, 0.99),
        1: ou_process(p.seed + 1, p.neighbor_util, 0.05, horizon_s=horizon_s),
        2: ou_process(p.seed + 2, p.neighbor_util, 0.05, horizon_s=horizon_s),
        3: constant(p.cloud_util),
    }
    bh = ou_process(p.seed + 3, p.backhaul_mbps * MBPS, 0.12 * p.backhaul_mbps * MBPS,
                    horizon_s=horizon_s,
                    lo=0.5 * p.backhaul_mbps * MBPS, hi=1.5 * p.backhaul_mbps * MBPS)
    bw_traces = {(0, 3): bh, (1, 3): bh, (2, 3): bh}
    return util_traces, bw_traces


def spike_onsets(p: MECScenarioParams, duration_s: float) -> tuple[float, ...]:
    """Start times of the home-MEC saturation spikes within [0, duration).

    The §IV background square wave saturates for ``spike_duty`` of every
    ``spike_period_s`` starting at phase 0 — the onset instants are where
    the admission controller's transient ρ excursion lives, and what
    the forecast A/B KPIs (``FleetSimResult.onset_max_rho``) measure.
    """
    return tuple(
        float(k * p.spike_period_s)
        for k in range(int(np.floor(duration_s / p.spike_period_s)) + 1)
        if k * p.spike_period_s < duration_s
    )


def build_mec_scenario(
    p: MECScenarioParams,
    *,
    adaptive: bool,
    thresholds: Thresholds = Thresholds(),
    device: str | torch.device = "cuda",
) -> EdgeSimulator:
    """The §IV single-session scenario; ``adaptive`` runs the orchestrator
    (its re-split DP on ``device``), else the static baseline, which needs
    no device."""
    graph = llama3_8b_graph()
    state = base_system_state(p)
    wl = Workload(tokens_in=p.tokens_in, tokens_out=p.tokens_out,
                  arrival_rate=p.arrival_rate)
    boundaries, assignment = static_baseline_split(graph)
    util_traces, bw_traces = mec_traces(p, p.duration_s + 10)

    profiler = CapacityProfiler(base_state=state)
    orch = None
    if adaptive:
        agents = [InProcessAgent(i) for i in range(state.num_nodes)]
        orch = AdaptiveOrchestrator(
            graph=graph,
            profiler=profiler,
            broadcast=ReconfigurationBroadcast(agents),
            workload=wl,
            thresholds=thresholds,
            weights=CostWeights(alpha=1.0, beta=0.02, gamma=1000.0),
            splitter=SplitRevision(strategy="dp+local", device=device),
            source_node=0,
        )
    return EdgeSimulator(
        graph=graph,
        base_state=state,
        workload=wl,
        util_traces=util_traces,
        bw_traces=bw_traces,
        orchestrator=orch,
        profiler=profiler,
        boundaries=boundaries,
        assignment=assignment,
        config=SimConfig(duration_s=p.duration_s, tick_s=0.1,
                         monitor_interval_s=1.0, seed=p.seed),
    )


# --------------------------------------------------------------------------- #
# regional (sharded) topology
# --------------------------------------------------------------------------- #
def regional_system_state(
    p: MECScenarioParams, n_regions: int, *,
    inter_region_mbps: float = 200.0,
) -> SystemState:
    """R replicas of the §IV cluster as one global C(t) with ``region_of``.

    Each region is the paper's 4-node cluster (3 trusted MEC + untrusted
    cloud); regions connect over metro backhaul links that the SHARDED
    control plane never places sessions across (they only exist so the
    global state is a valid SystemState — the block-diagonal slices are
    what the per-region orchestrators price against).
    """
    base = base_system_state(p)
    k = base.num_nodes
    n = k * n_regions
    bw = np.full((n, n), inter_region_mbps * MBPS)
    lat = np.full((n, n), 8 * p.base_latency_s)
    names: list[str] = []
    for r in range(n_regions):
        sl = slice(r * k, (r + 1) * k)
        bw[sl, sl] = base.link_bw
        lat[sl, sl] = base.link_lat
        names.extend(f"r{r}:{nm}" for nm in base.names)
    return SystemState(
        flops_per_s=np.tile(base.flops_per_s, n_regions),
        mem_bytes=np.tile(base.mem_bytes, n_regions),
        background_util=np.tile(base.background_util, n_regions),
        trusted=np.tile(base.trusted, n_regions),
        link_bw=bw,
        link_lat=lat,
        mem_bw=np.tile(base.mem_bw, n_regions),
        names=tuple(names),
        region_of=np.repeat(np.arange(n_regions), k),
    )


def regional_traces(
    p: MECScenarioParams, n_regions: int, horizon_s: float
) -> tuple[dict[int, Trace], dict[tuple[int, int], Trace]]:
    """§IV environment dynamics replicated per region in GLOBAL node ids.

    Region r's traces re-seed with ``p.seed + 100*r`` so regions fluctuate
    independently but deterministically (seed-paired A/Bs still hold)."""
    util_traces: dict[int, Trace] = {}
    bw_traces: dict[tuple[int, int], Trace] = {}
    k = 4
    for r in range(n_regions):
        pr = MECScenarioParams(**{
            **{f: getattr(p, f) for f in p.__dataclass_fields__},
            "seed": p.seed + 100 * r,
        })
        ut, bt = mec_traces(pr, horizon_s)
        for node, tr in ut.items():
            util_traces[r * k + node] = tr
        for (i, j), tr in bt.items():
            bw_traces[(r * k + i, r * k + j)] = tr
    return util_traces, bw_traces


def build_regional_orchestrator(
    p: MECScenarioParams, n_regions: int, *,
    thresholds: Thresholds | None = None,
    use_fixed_point: bool = True,
    fixed_point_sweeps: int = 8,
    cost_model=None,
    device: str | torch.device = "cuda",
) -> ShardedFleetOrchestrator:
    """One :class:`FleetOrchestrator` per §IV cluster replica, wrapped.

    Every region gets its own broadcast agents, profiler (over the
    region-local slice of :func:`regional_system_state`), and resident
    kernel, all on ``device``; ``n_regions == 1`` produces a wrapper that
    delegates verbatim (bit-identical to an unsharded
    :class:`FleetOrchestrator`)."""
    gstate = regional_system_state(p, n_regions)
    th = thresholds if thresholds is not None else Thresholds(cooldown_s=10.0)
    inners = []
    for r in range(n_regions):
        local = base_system_state(p)
        inners.append(FleetOrchestrator(
            profiler=CapacityProfiler(base_state=local),
            broadcast=ReconfigurationBroadcast(
                [InProcessAgent(i) for i in range(local.num_nodes)]
            ),
            thresholds=th,
            weights=CostWeights(alpha=1.0, beta=0.02, gamma=1000.0),
            use_fixed_point=use_fixed_point,
            fixed_point_sweeps=fixed_point_sweeps,
            cost_model=cost_model,
            device=device,
        ))
    wrapper = ShardedFleetOrchestrator(
        inners, region_of=gstate.region_of)
    wrapper.profiler.base_state = gstate
    return wrapper


# --------------------------------------------------------------------------- #
# multi-session fleet scenario
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FleetScenarioParams:
    """Multi-tenant variant of the §IV topology: same 3 MEC + cloud fleet,
    many concurrent sessions with churn instead of one pinned session.

    Churn/workload knobs live in the embedded :class:`FleetSimConfig` (the
    simulator's own config — one source of truth, no field copying)."""

    mec: MECScenarioParams = MECScenarioParams()
    sim: FleetSimConfig = FleetSimConfig()
    archs: tuple[str, ...] = _FLEET_ARCHS


def build_fleet_scenario(
    p: FleetScenarioParams,
    *,
    thresholds: Thresholds | None = None,
    admission: FleetAdmissionController | None = None,
    device: str | torch.device = "cuda",
) -> FleetSimulator:
    """Multi-session §IV scenario; ``admission`` overrides the controller the
    simulator would otherwise build from ``p.sim`` (custom rho ceilings /
    queue depths in tests and sweeps).  ``p.sim.n_regions > 1`` replicates
    the cluster per region and runs through the sharded control plane.
    Every orchestrator is built on ``device``."""
    m = p.mec
    if p.sim.n_regions > 1:
        R = p.sim.n_regions
        gstate = regional_system_state(m, R)
        util_traces, bw_traces = regional_traces(m, R, p.sim.duration_s + 10)
        wrapper = build_regional_orchestrator(
            m, R, thresholds=thresholds,
            use_fixed_point=p.sim.fixed_point,
            fixed_point_sweeps=p.sim.fixed_point_sweeps,
            device=device,
        )
        cfg = p.sim
        if cfg.ingress_nodes == (0, 1, 2):
            # default ingress generalizes to every region's MEC nodes
            cfg = replace(cfg, ingress_nodes=tuple(
                4 * r + i for r in range(R) for i in (0, 1, 2)))
        return FleetSimulator(
            base_state=gstate,
            catalog=fleet_model_catalog(p.archs),
            util_traces=util_traces,
            bw_traces=bw_traces,
            orchestrator=wrapper,
            config=cfg,
            admission=admission,
        )
    state = base_system_state(m)
    util_traces, bw_traces = mec_traces(m, p.sim.duration_s + 10)

    orch = FleetOrchestrator(
        profiler=CapacityProfiler(base_state=state),
        broadcast=ReconfigurationBroadcast(
            [InProcessAgent(i) for i in range(state.num_nodes)]
        ),
        # tighter per-session cool-down than the paper's single-session 30 s:
        # re-splits are batched (one vmapped solve per cycle), so the rate
        # limit guards thrash per session, not solver budget — and sessions
        # live ~1 min, which a 30 s cool-down would mostly freeze
        thresholds=thresholds if thresholds is not None else Thresholds(
            cooldown_s=10.0
        ),
        weights=CostWeights(alpha=1.0, beta=0.02, gamma=1000.0),
        use_fixed_point=p.sim.fixed_point,
        fixed_point_sweeps=p.sim.fixed_point_sweeps,
        device=device,
    )
    return FleetSimulator(
        base_state=state,
        catalog=fleet_model_catalog(p.archs),
        util_traces=util_traces,
        bw_traces=bw_traces,
        orchestrator=orch,
        config=p.sim,
        admission=admission,
    )
