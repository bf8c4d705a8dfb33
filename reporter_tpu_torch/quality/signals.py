"""Per-batch match-quality signal extraction, host-side.

Counterpart: reporter_tpu/quality/signals.py. A handful of correctness
PROXIES computed from what ``match_many`` already holds on the host —
the columnar ``MatchBatch`` (flat ``RecordColumns``) or per-trace
``SegmentRecord`` lists — with no device work:

  empty_match_rate       nonempty input traces that produced NO record
  breakage_rate          same-trace consecutive record pairs whose
                         boundary times don't touch while both flanks are
                         complete: the HMM chain broke mid-trace
  discontinuity_rate     same-trace consecutive pairs with a PARTIAL (-1)
                         boundary mid-trace: the walk could not connect
                         what the decoder emitted
  violation_rate         complete non-internal records whose implied
                         speed exceeds ``max_speed_mps``
  rejection_rate         records the fully-traversed report filter drops
  unmatched_point_rate   decoder points with no edge assignment

They are proxies, not ground truth: the sampled shadow-oracle audit
(quality/audit.py) measures disagreement against the reference_cpu
oracle on a few batches.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

__all__ = ["QualitySignals", "signals_from_columns",
           "signals_from_records", "extract", "DEFAULT_MAX_SPEED_MPS"]

# Implied-speed violation threshold: 60 m/s (216 km/h) is beyond any
# legal traversal the auto mode should report; slower modes only make
# the default more conservative. Overridable per monitor
# (RTPU_QUALITY_MAX_SPEED).
DEFAULT_MAX_SPEED_MPS = 60.0

# Boundary-time adjacency tolerance: the same constant the report
# builder's next-segment chaining uses (service/reports.build_reports),
# so "the chain broke" means the same thing to telemetry and to reports.
_ADJ_TOL = 1e-3


class QualitySignals(NamedTuple):
    """Raw counts for one match_many batch (rates derive in the
    monitor, so window aggregation stays exact — summing rates isn't)."""

    traces: int            # nonempty input traces
    points: int            # input probe points
    records: int           # record rows emitted
    empty_traces: int      # nonempty traces with zero record rows
    pairs: int             # same-trace consecutive record pairs
    breakages: int         # clean chain breaks (both flanks complete)
    discontinuities: int   # partial mid-trace boundaries (walk/routing)
    speed_checked: int     # complete non-internal records with dur > 0
    speed_violations: int  # implied speed > max_speed_mps
    rejected: int          # rows the fully-traversed filter drops
    unmatched_points: "int | None" = None   # decoder points with no edge

    def merged(self, other: "QualitySignals") -> "QualitySignals":
        u = (None if self.unmatched_points is None
             and other.unmatched_points is None
             else (self.unmatched_points or 0)
             + (other.unmatched_points or 0))
        return QualitySignals(*(a + b for a, b in
                                zip(self[:10], other[:10])),
                              unmatched_points=u)


def _from_arrays(trace: np.ndarray, seg_complete: np.ndarray,
                 start: np.ndarray, end: np.ndarray,
                 length: np.ndarray, internal: np.ndarray,
                 n_traces: int, trace_nonempty: np.ndarray,
                 points: int, max_speed: float,
                 unmatched: "int | None") -> QualitySignals:
    """The one implementation both input forms reduce to. ``trace`` must
    be nondecreasing (RecordColumns' contract; the record-list form
    emits rows in trace order by construction)."""
    n = len(trace)
    reportable = seg_complete & ~internal
    # empty-match: nonempty traces with zero record rows AT ALL — a
    # trace with only partial/internal rows still matched onto the map
    # (common on tiny/long-segment tiles); the rejection signal prices
    # the filter separately
    per_trace = np.zeros(n_traces, np.int64)
    if n:
        np.add.at(per_trace, trace, 1)
    empty = int((trace_nonempty & (per_trace == 0)).sum())
    # pair structure within traces
    if n > 1:
        same = trace[1:] == trace[:-1]
        touch = np.abs(start[1:] - end[:-1]) < _ADJ_TOL
        flanks_complete = seg_complete[1:] & seg_complete[:-1]
        pairs = int(same.sum())
        breakages = int((same & ~touch & flanks_complete).sum())
        # a partial boundary BETWEEN records of one trace: the walk
        # could not observe the hand-off (routing split / unobserved
        # entry-exit), which a clean chain break never produces on its
        # complete flanks
        partial_boundary = (end[:-1] < 0.0) | (start[1:] < 0.0)
        discontinuities = int((same & partial_boundary).sum())
    else:
        pairs = breakages = discontinuities = 0
    dur = end - start
    ok = reportable & (dur > 0)
    checked = int(ok.sum())
    violations = int((length[ok] > max_speed * dur[ok]).sum())
    rejected = n - int(reportable.sum())
    return QualitySignals(
        traces=int(trace_nonempty.sum()), points=int(points), records=n,
        empty_traces=empty, pairs=pairs, breakages=breakages,
        discontinuities=discontinuities, speed_checked=checked,
        speed_violations=violations, rejected=rejected,
        unmatched_points=unmatched)


def signals_from_columns(cols, n_traces: int, points: int,
                         trace_nonempty: np.ndarray,
                         max_speed: float = DEFAULT_MAX_SPEED_MPS,
                         unmatched: "int | None" = None) -> QualitySignals:
    """Signals from a MatchBatch's RecordColumns: vectorized numpy over
    the columns the harvest already built."""
    complete = (cols.start_time >= 0.0) & (cols.end_time >= 0.0)
    return _from_arrays(cols.trace, complete, cols.start_time,
                        cols.end_time, cols.length,
                        np.asarray(cols.internal, bool), n_traces,
                        trace_nonempty, points, max_speed, unmatched)


def signals_from_records(per_trace: Sequence, points: int,
                         trace_nonempty: np.ndarray,
                         max_speed: float = DEFAULT_MAX_SPEED_MPS,
                         unmatched: "int | None" = None) -> QualitySignals:
    """Signals from per-trace SegmentRecord lists (match_many's list form:
    one trace, or a trace past the largest bucket), element-equivalent
    to the columnar form on the same records."""
    rows = [(i, r) for i, recs in enumerate(per_trace) for r in recs]
    n = len(rows)
    trace = np.fromiter((i for i, _ in rows), np.int32, n)
    start = np.fromiter((r.start_time for _, r in rows), np.float64, n)
    end = np.fromiter((r.end_time for _, r in rows), np.float64, n)
    length = np.fromiter((r.length for _, r in rows), np.float64, n)
    internal = np.fromiter((r.internal for _, r in rows), bool, n)
    complete = (start >= 0.0) & (end >= 0.0)
    return _from_arrays(trace, complete, start, end, length, internal,
                        len(per_trace), trace_nonempty, points,
                        max_speed, unmatched)


def extract(result, n_traces: int, points: int,
            trace_nonempty: np.ndarray,
            max_speed: float = DEFAULT_MAX_SPEED_MPS,
            unmatched: "int | None" = None) -> QualitySignals:
    """Dispatch on the match_many result shape: columnar MatchBatch
    (read .columns directly — never materialize records for telemetry)
    vs per-trace record lists."""
    cols = getattr(result, "columns", None)
    if cols is not None:
        return signals_from_columns(cols, n_traces, points,
                                    trace_nonempty, max_speed, unmatched)
    return signals_from_records(result, points, trace_nonempty,
                                max_speed, unmatched)
