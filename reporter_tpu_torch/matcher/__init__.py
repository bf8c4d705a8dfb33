"""The matcher API and the host edge walk. The names the JAX package's
``reporter_tpu.matcher`` exports, and ``Trace``."""

from reporter_tpu_torch.matcher.api import MatchedPoint, SegmentMatcher, Trace
from reporter_tpu_torch.matcher.segments import SegmentRecord, build_segments

__all__ = ["SegmentMatcher", "MatchedPoint", "SegmentRecord",
           "build_segments", "Trace"]
