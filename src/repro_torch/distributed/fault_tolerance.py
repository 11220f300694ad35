"""Fault tolerance: node liveness from heartbeats, training stragglers.

The fleet control plane's ``node-fail`` trigger class reads a
:class:`HeartbeatRegistry`: a node that misses ``miss_limit`` beats is
declared dead, and every session whose chain touches it is forced into the
monitoring cycle's solve set.  The training driver feeds step times to a
:class:`StragglerDetector`, the paper's latency trigger transplanted to
training.  :func:`plan_elastic_mesh` sizes the mesh a restore re-shards
onto after devices are lost.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["HeartbeatRegistry", "StragglerDetector", "plan_elastic_mesh"]


@dataclass
class HeartbeatRegistry:
    """Tracks liveness; a node missing ``miss_limit`` beats is declared dead.

    Death is not terminal: a beat from a dead node revives it immediately
    (MTTR-recovered hardware re-announces itself), and the revival is
    queued for :meth:`drain_revived` so the orchestrator can fold the
    returning capacity back in, so a failure storm does not permanently
    shrink the fleet.
    """

    nodes: list[int]
    miss_limit: int = 3
    _last_beat: dict[int, int] = field(default_factory=dict)
    _dead: set = field(default_factory=set)
    _revived: list[int] = field(default_factory=list)
    _tick: int = 0

    def beat(self, node: int) -> None:
        if node in self._dead:
            self.rejoin(node)
        else:
            self._last_beat[node] = self._tick

    def rejoin(self, node: int) -> None:
        """Explicitly re-admit a node (idempotent; also what a beat from a
        dead node does)."""
        self._dead.discard(node)
        if node not in self._revived:
            self._revived.append(node)
        self._last_beat[node] = self._tick

    def tick(self) -> list[int]:
        """Advance one interval; returns NEWLY-dead nodes."""
        self._tick += 1
        newly = []
        for n in self.nodes:
            if n in self._dead:
                continue
            if self._tick - self._last_beat.get(n, 0) >= self.miss_limit:
                self._dead.add(n)
                newly.append(n)
        return newly

    def alive(self) -> list[int]:
        return [n for n in self.nodes if n not in self._dead]

    def dead(self) -> list[int]:
        return [n for n in self.nodes if n in self._dead]

    def drain_revived(self) -> list[int]:
        """Nodes that came back since the last drain (each reported once)."""
        out, self._revived = self._revived, []
        return out


@dataclass
class StragglerDetector:
    """Per-worker step-time EWMA; flags workers slower than median × ratio.

    This is the paper's U_max trigger transplanted to training: the
    detector's output feeds the same decision path (migrate -> re-split),
    there realized as stage rebalancing or a hot-spare swap.
    """

    ratio: float = 1.5
    alpha: float = 0.3
    _ewma: dict = field(default_factory=dict)     # worker -> core.triggers.EWMA

    def observe(self, worker: int, step_time_s: float) -> None:
        # imported here: repro_torch.core imports this module (HeartbeatRegistry)
        from ..core.triggers import EWMA

        self._ewma.setdefault(worker, EWMA(self.alpha)).update(step_time_s)

    def stragglers(self) -> list[int]:
        if len(self._ewma) < 2:
            return []
        vals = {w: e.get() for w, e in self._ewma.items()}
        med = float(np.median(list(vals.values())))
        return [w for w, v in vals.items() if v > self.ratio * med]


def plan_elastic_mesh(alive_devices: int, *, model_axis: int = 16,
                      pods: int | None = None) -> dict:
    """Largest power-of-two mesh fitting the surviving devices.

    Keeps the TP ("model") axis intact — TP degree is baked into layouts —
    and shrinks the data/pod axes, so a restore is a pure DP re-shard of the
    checkpoint (no weight-layout change).
    """
    if alive_devices < model_axis:
        raise RuntimeError(
            f"fewer devices ({alive_devices}) than the TP axis ({model_axis}); "
            "full restart with a smaller TP layout required")
    dp_total = alive_devices // model_axis
    dp = 2 ** int(math.floor(math.log2(dp_total)))
    shape = {"data": dp, "model": model_axis}
    if pods is not None and pods > 1 and dp % pods == 0 and dp // pods >= 1:
        shape = {"pod": pods, "data": dp // pods, "model": model_axis}
    return {"shape": shape, "devices_used": dp * model_axis,
            "devices_idle": alive_devices - dp * model_axis}
