"""Quickstart: the paper's loop, the port's counterpart of examples/quickstart.py.

Builds a model graph, watches a fluctuating edge environment, and shows the
orchestrator migrate + re-split as conditions change — then verifies the
split execution is numerically identical to the monolith on a real model.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(default cuda: the re-split DP and the model run on the card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_bundle
from repro_torch.core import (
    AdaptiveOrchestrator,
    CapacityProfiler,
    InProcessAgent,
    ReconfigurationBroadcast,
    SplitRevision,
    Thresholds,
    Workload,
)
from repro_torch.device import resolve_device
from repro_torch.edgesim import MECScenarioParams, base_system_state
from repro_torch.serving import SplitInferenceEngine


def main(device: str = "cuda", bundle=None, params=None) -> dict:
    """Steps 1-5 on ``bundle`` and ``params`` (default: reduced llama3-8b
    from seed 0 on ``device``); returns the facts printed: the graph, the
    initial and new split, the decision, and split vs monolith."""
    dev = resolve_device(device)
    # 1. a real (reduced-scale) model + its computational graph -----------
    if bundle is None:
        bundle = get_bundle("llama3-8b", reduced=True)
    if params is None:
        params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                             torch.float32)
    graph = bundle.model_graph()
    print(f"graph: {graph}")

    # 2. edge environment: 3 MEC nodes + cloud ----------------------------
    p = MECScenarioParams(backhaul_mbps=20.0)        # constrained backhaul
    state = base_system_state(p)
    wl = Workload(tokens_in=56, tokens_out=8, arrival_rate=4.0)
    profiler = CapacityProfiler(base_state=state)
    orch = AdaptiveOrchestrator(
        graph=graph, profiler=profiler,
        broadcast=ReconfigurationBroadcast(
            [InProcessAgent(i) for i in range(state.num_nodes)]),
        workload=wl, thresholds=Thresholds(), splitter=SplitRevision(device=dev))

    # 3. deploy the paper's static baseline {S1, S2, S3} ------------------
    initial = orch.deploy_initial(graph.even_split(3).boundaries, (0, 3, 0))
    print(f"initial split {initial.boundaries} on nodes {initial.assignment}")

    # 4. congest the backhaul; watch the orchestrator react ---------------
    profiler.observe_latency(0.450)                  # EWMA latency spikes
    profiler.observe_links(state.link_bw)
    decision = orch.step(now=100.0)
    print(f"decision: {decision.kind.value}, reasons={list(decision.reasons)}")
    print(f"new split {orch.current.boundaries} on nodes {orch.current.assignment}")

    # 5. the split never changes the math ---------------------------------
    engine = SplitInferenceEngine(bundle, params)
    engine.apply_config(orch.current)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, bundle.cfg.vocab, (2, 16), dtype=np.int32), device=dev)
    split_logits = engine.infer_logits(toks)
    mono_logits = engine.infer_monolithic(toks)
    err = float((split_logits - mono_logits).abs().max())
    print(f"split vs monolithic max |Δlogit| = {err:.2e}")
    if not (bool(torch.isfinite(split_logits).all()) and err < 1e-3):
        raise AssertionError(f"split != monolith: max |Δlogit| {err}")
    print("OK")
    return {"graph": graph, "initial": initial, "decision": decision,
            "config": orch.current, "logits": split_logits, "err": err}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
