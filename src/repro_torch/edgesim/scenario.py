"""§IV scenario: 5G-MEC urban, 3 MEC nodes + cloud.

Topology (paper §IV-a):

    node 0  home MEC   (A100-40GB class, trusted; receives requests)
    node 1  MEC-2      (A100-40GB class, trusted; edge-to-edge link)
    node 2  MEC-3      (A100-40GB class, trusted; edge-to-edge link)
    node 3  cloud      (multi-GPU pool, UNtrusted; reached over the backhaul)

:func:`fleet_model_catalog` lists the heterogeneous model configs the
multi-session fleet draws its sessions from; :func:`regional_system_state`
and :func:`build_regional_orchestrator` replicate the cluster as R MEC
regions under one region-sharded control plane.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.broadcast import InProcessAgent, ReconfigurationBroadcast
from ..core.cost_model import CostWeights, SystemState
from ..core.fleet import FleetOrchestrator, ShardedFleetOrchestrator
from ..core.profiling import CapacityProfiler
from ..core.triggers import Thresholds

__all__ = ["MBPS", "MECScenarioParams", "base_system_state",
           "build_regional_orchestrator", "fleet_model_catalog",
           "regional_system_state"]

MBPS = 1e6 / 8.0  # bytes/s per Mb/s


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
