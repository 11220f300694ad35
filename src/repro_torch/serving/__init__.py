"""Split-inference serving: segments, transport, engine."""

from .engine import SplitInferenceEngine
from .segments import BoundSegment, SegmentChain, SegmentRunner, split_params
from .transfer import ActivationTransport, TransferStats

__all__ = ["ActivationTransport", "BoundSegment", "SegmentChain",
           "SegmentRunner", "SplitInferenceEngine", "TransferStats",
           "split_params"]
