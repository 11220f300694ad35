"""Segment profiler: measure real per-segment cost through the serving path.

The control plane prices the ANALYTIC cost model (``repro_torch.core.
cost_model``); this module produces the measured coefficients that calibrate
it.  For one model it drives a :class:`~repro_torch.serving.segments.
SegmentChain` — the same entrypoint the inference engine uses, so the
measured forward runs the real kernels (K1 flash attention in every layer,
K2 int8 transfer when the transport compresses) — and records, per segment
[lo, hi):

* ``step_time_s`` — median wall time of the segment's prefill forward over
  ``reps`` runs after ``warmup`` runs, each bracketed by
  ``torch.cuda.synchronize()`` on the card (the host clock alone would time
  the enqueue);
* ``boundary_bytes_tok`` — measured wire bytes/token crossing the cut at
  ``hi``, via :class:`~repro_torch.serving.transfer.ActivationTransport`;
* the analytic predictions for both, so the profile stores *ratios*.

The analytic side needs a node FLOP rate; as in the reference, the profiler
solves the paper's Eq. 1 capacity estimate from its own data — the effective
rate that makes total analytic time equal total measured time — so the
per-segment ratios capture the SHAPE of the deviation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.cost_model import SystemState, Workload, segment_exec_time
from ..core.profiling import ModelProfile, SegmentProfileEntry
from ..models.api import ModelBundle
from .segments import SegmentChain
from .transfer import ActivationTransport

__all__ = ["SegmentProfiler"]


def _profiling_state(flops_per_s: float) -> SystemState:
    """A single pristine node at the estimated effective FLOP rate."""
    return SystemState(
        flops_per_s=np.array([flops_per_s]),
        mem_bytes=np.array([np.inf]),
        background_util=np.array([0.0]),
        trusted=np.array([True]),
        link_bw=np.full((1, 1), np.inf),
        link_lat=np.zeros((1, 1)),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class SegmentProfiler:
    """Measures one model's per-segment step time + boundary wire bytes.

    Runs on the device that holds ``params`` (no default: the reference's
    float32 init would be 32 GB at full width).  ``compress=True`` routes
    boundary activations through the int8 kernels, so the measured
    bytes/token reflect the compressed wire format.  Input tokens come from
    ``numpy.random.default_rng(seed + 1)``.
    """

    bundle: ModelBundle
    params: Any                  # on the device to measure
    batch: int = 2
    tokens: int = 32
    reps: int = 3
    warmup: int = 1
    compress: bool = False
    seed: int = 0
    transport: ActivationTransport = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.transport is None:
            self.transport = ActivationTransport(compress=self.compress)

    # ---------------------------------------------------------------- core --
    def profile(self, boundaries: tuple[int, ...] | None = None) -> ModelProfile:
        b = self.bundle
        graph = b.model_graph()
        n = len(graph)
        if boundaries is None:
            k = max(1, min(4, n - 1))
            boundaries = tuple(sorted({round(i * n / k) for i in range(k + 1)}))
        dev = self.params["embed"].device
        toks = torch.as_tensor(np.random.default_rng(self.seed + 1).integers(
            0, b.cfg.vocab, (self.batch, self.tokens), dtype=np.int32), device=dev)
        chain = SegmentChain(b, self.params, boundaries,
                             transfer_hook=self.transport)

        # one accounted pass: boundary wire bytes + per-segment inputs
        inputs: list[Any] = []
        x = toks
        for seg in chain.segments:
            inputs.append(x)
            x = seg(x)
            if seg.hi < n:
                x = self.transport(len(inputs) - 1, x)
        _sync(dev)
        n_tok = float(self.batch * self.tokens)
        wire_tok = {j: w / n_tok
                    for j, w in self.transport.stats.per_boundary.items()}

        # timed per-segment passes (warmup covers first-use kernel builds)
        times = []
        for seg, xin in zip(chain.segments, inputs):
            for _ in range(self.warmup):
                seg(xin)
            samples = []
            for _ in range(self.reps):
                _sync(dev)
                t0 = time.perf_counter()
                seg(xin)
                _sync(dev)
                samples.append(time.perf_counter() - t0)
            times.append(float(np.median(samples)))

        # Eq. 1 effective capacity: the rate that explains the total time
        wl = Workload(tokens_in=int(n_tok), tokens_out=0, arrival_rate=0.0)
        total_flops = sum(graph.segment_flops(lo, hi)
                          for lo, hi in zip(boundaries[:-1], boundaries[1:]))
        f_eff = wl.tokens_in * total_flops / max(sum(times), 1e-12)
        state = _profiling_state(f_eff)

        segs = []
        for j, ((lo, hi), t) in enumerate(
                zip(zip(boundaries[:-1], boundaries[1:]), times)):
            analytic = segment_exec_time(graph, lo, hi, 0, state, wl)
            interior = hi < n
            segs.append(SegmentProfileEntry(
                lo=int(lo), hi=int(hi),
                step_time_s=t, analytic_time_s=float(analytic),
                boundary_bytes_tok=wire_tok.get(j, 0.0) if interior else 0.0,
                analytic_boundary_bytes_tok=float(
                    graph.boundary_act_bytes(hi)) if interior else 0.0,
            ))
        return ModelProfile(
            arch=b.arch, family=b.family, graph_units=n,
            batch=self.batch, tokens=self.tokens,
            compressed_transfer=self.compress, segments=tuple(segs),
        )
