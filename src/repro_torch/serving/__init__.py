"""Split-inference serving: segments, transport, engine, batching, profiler."""

from .batching import BatchStats, Request, WaveBatcher
from .engine import SplitInferenceEngine
from .profiler import SegmentProfiler
from .segments import (BoundSegment, SegmentChain, SegmentRunner, run_chain,
                       split_params)
from .transfer import ActivationTransport, TransferStats

__all__ = ["ActivationTransport", "BatchStats", "BoundSegment", "Request",
           "SegmentChain", "SegmentProfiler", "SegmentRunner",
           "SplitInferenceEngine", "TransferStats", "WaveBatcher", "run_chain",
           "split_params"]
