"""Serving entry point: adaptive split inference over the §IV edge scenario.

Combines the pieces end-to-end: a SplitInferenceEngine executes a real model
under the partition configs that the Adaptive Orchestrator commits.
Per-request latencies are priced by the cost model; the numerics of every
request flow through the actual split segment chain (int8 transport
optional, kernel K2) and every prefill attention through kernel K1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 32
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --param-dtype bfloat16 --compress --requests 8 --prompt-len 512

``--full`` serves the full-width, full-depth model (random weights from a
seed); the default is the reduced model.  ``--n-layers N`` keeps the first
N layers only (full or reduced width unchanged: a model whose weights do not
fit one card is cut in depth, never in width).  ``--device`` defaults to
cuda.
"""

from __future__ import annotations

import argparse
import dataclasses

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
    chain_latency,
)
from repro_torch.device import resolve_device
from repro_torch.edgesim import MECScenarioParams, base_system_state
from repro_torch.models.api import bundle_for
from repro_torch.serving import ActivationTransport, SplitInferenceEngine

_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--backhaul-mbps", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width, full-depth model instead of the reduced one")
    ap.add_argument("--param-dtype", choices=sorted(_PARAM_DTYPES),
                    default="float32")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="keep the first N layers (a cut in depth only)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> tuple[dict, SplitInferenceEngine]:
    """Serve ``args.requests`` requests; returns the summary and the engine."""
    dev = resolve_device(args.device)
    bundle = get_bundle(args.arch, reduced=not args.full)
    if args.n_layers is not None:
        if not 0 < args.n_layers <= bundle.cfg.n_layers:
            raise ValueError(f"--n-layers {args.n_layers}: {args.arch} has "
                             f"{bundle.cfg.n_layers} layers")
        bundle = bundle_for(args.arch, dataclasses.replace(
            bundle.cfg, n_layers=args.n_layers))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen, dev, _PARAM_DTYPES[args.param_dtype])
    engine = SplitInferenceEngine(
        bundle, params,
        transport=ActivationTransport(compress=args.compress))

    # orchestration substrate over the model's REAL graph
    graph = bundle.model_graph()
    p = MECScenarioParams(backhaul_mbps=args.backhaul_mbps)
    state = base_system_state(p)
    wl = Workload(tokens_in=args.prompt_len, tokens_out=8, arrival_rate=2.0)
    profiler = CapacityProfiler(base_state=state)
    agents = [InProcessAgent(i) for i in range(state.num_nodes)]
    orch = AdaptiveOrchestrator(
        graph=graph, profiler=profiler,
        broadcast=ReconfigurationBroadcast(agents), workload=wl,
        thresholds=Thresholds(), splitter=SplitRevision(device=dev))
    L = len(graph)
    cfg0 = orch.deploy_initial((0, max(1, L // 3), max(2, 2 * L // 3), L),
                               (0, 3, 0))
    engine.apply_config(cfg0)

    rng = np.random.default_rng(0)
    lat, reconfigs = [], 0
    for i in range(args.requests):
        toks = torch.as_tensor(rng.integers(0, bundle.cfg.vocab,
                                            (1, args.prompt_len), dtype=np.int32),
                               device=dev)
        logits = engine.infer_logits(toks)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"request {i}: non-finite logits")
        c = orch.current
        lat.append(chain_latency(graph, c.boundaries, c.assignment,
                                 profiler.system_state(), wl))
        profiler.observe_latency(lat[-1])
        profiler.observe_links(state.link_bw)
        d = orch.step(now=float(i))
        if d.config is not None and d.config.version != engine.config.version:
            engine.apply_config(d.config)
            reconfigs += 1
    stats = engine.transfer_stats()
    out = {
        "requests": args.requests,
        "mean_latency_ms": round(float(np.mean(lat)) * 1e3, 1),
        "reconfigurations": reconfigs,
        "wire_MB": round(stats.wire_bytes / 1e6, 2),
        "compression_ratio": round(stats.compression_ratio, 2),
        "final_split": str(engine.config.boundaries),
    }
    return out, engine


def main(argv=None) -> dict:
    out, _ = run(parse_args(argv))
    print(out)
    return out


if __name__ == "__main__":
    main()
