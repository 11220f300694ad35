"""End-to-end §IV scenario: static vs adaptive under a backhaul sweep, with
a node-failure drill; the port's counterpart of examples/edge_orchestration.py.

Run:  PYTHONPATH=src python -m repro_torch.examples.edge_orchestration [--device cpu]
(default cuda: the adaptive arm's re-split DP runs on the card).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import DecisionKind
from repro_torch.device import resolve_device
from repro_torch.edgesim import MECScenarioParams, build_mec_scenario


def main(device: str = "cuda", *, bandwidths=(20, 50, 100, 200),
         duration_s: float = 60.0, window=(20.0, 60.0),
         drill_duration_s: float = 80.0, fail_at: float = 40.0) -> dict:
    """Table II at ``bandwidths`` (``window``'s KPIs of runs of
    ``duration_s``), then MEC-2 (node 1) saturated from ``fail_at`` in a
    ``drill_duration_s`` run at 50 Mb/s; returns the KPIs and the drill's
    facts."""
    dev = resolve_device(device)
    print("== Table II reproduction (steady-state, "
          f"{window[0]:.0f}-{window[1]:.0f}s window) ==")
    table = {}
    for bw in bandwidths:
        row = {}
        for adaptive in (False, True):
            p = MECScenarioParams(backhaul_mbps=bw, duration_s=duration_s)
            res = build_mec_scenario(p, adaptive=adaptive, device=dev).run()
            row["adaptive" if adaptive else "static"] = res.kpis(*window)
        table[bw] = row
        s = row["static"]["mean_latency_s"] * 1e3
        a = row["adaptive"]["mean_latency_s"] * 1e3
        print(f"backhaul {bw:>3} Mb/s: static {s:5.0f} ms | adaptive {a:5.0f} ms "
              f"| Δ {100 * (a / s - 1):+.0f}%")

    print("\n== node-failure drill: kill MEC-2 mid-run, watch re-placement ==")
    p = MECScenarioParams(backhaul_mbps=50.0, duration_s=drill_duration_s)
    sim = build_mec_scenario(p, adaptive=True, device=dev)

    # fail node 1 at fail_at by saturating it completely (dead == 100% util)
    orig_trace = sim.util_traces[1]
    sim.util_traces[1] = type(orig_trace)(
        lambda t: 0.99 if t >= fail_at else orig_trace(t), 0.0, 0.99)
    res = sim.run()
    uses_node1_before = any(1 in d.config.assignment for d in
                            sim.orch.decisions[:int(fail_at) - 5] if d.config)
    final_cfg = sim.orch.current
    print(f"node 1 used before failure: {uses_node1_before}")
    print(f"final assignment (post-failure): {final_cfg.assignment} "
          f"(node 1 {'EVICTED' if 1 not in final_cfg.assignment else 'still used'})")
    kinds = [d.kind for d in sim.orch.decisions if d.kind in
             (DecisionKind.MIGRATE, DecisionKind.RESPLIT)]
    print(f"reconfigurations: {len(kinds)} ({[k.value for k in kinds]})")

    lat_pre = np.mean([m.latency_s for m in res.window(fail_at - 10, fail_at)]) * 1e3
    lat_post = np.mean([m.latency_s for m in res.window(
        drill_duration_s - 20, drill_duration_s)]) * 1e3
    print(f"latency before failure {lat_pre:.0f} ms -> after recovery "
          f"{lat_post:.0f} ms")
    return {"table": table, "uses_node1_before": uses_node1_before,
            "final_assignment": final_cfg.assignment,
            "final_boundaries": final_cfg.boundaries,
            "reconfigurations": [k.value for k in kinds],
            "latency_pre_ms": float(lat_pre), "latency_post_ms": float(lat_post)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
