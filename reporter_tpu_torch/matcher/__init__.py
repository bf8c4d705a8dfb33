"""The matcher API and the host edge walk."""

from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace

__all__ = ["SegmentMatcher", "Trace"]
