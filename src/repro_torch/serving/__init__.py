"""Split-inference serving: segments, transport, engine, batching, profiler."""

from .batching import BatchStats, Request, WaveBatcher
from .engine import SplitInferenceEngine
from .profiler import SegmentProfiler
from .segments import BoundSegment, SegmentChain, SegmentRunner, split_params
from .transfer import ActivationTransport, TransferStats

__all__ = ["ActivationTransport", "BatchStats", "BoundSegment", "Request",
           "SegmentChain", "SegmentProfiler", "SegmentRunner",
           "SplitInferenceEngine", "TransferStats", "WaveBatcher",
           "split_params"]
