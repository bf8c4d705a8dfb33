"""Segment filter and report builder.

Counterpart: reporter_tpu/service/reports.py (``Report``,
``build_reports``, ``filter_segments``, ``latest_complete_time``). Only
*fully traversed* OSMLR segments become reports (entry and exit both
observed); internal connector edges and sub-minimum lengths are dropped,
and each report pairs ``segment_id`` with the ``next_segment_id``
actually driven onto, which the datastore needs for turn-level speeds.
"""

from __future__ import annotations

from dataclasses import dataclass

from reporter_tpu_torch.matcher.segments import SegmentRecord


@dataclass
class Report:
    """One datastore report row."""

    segment_id: int
    next_segment_id: int | None     # None ⇒ exit to unknown / end of trace
    start_time: float               # t0: entered segment
    end_time: float                 # t1: left segment
    length: float                   # meters driven on the segment
    queue_length: float = 0.0

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def to_json(self) -> dict:
        return {
            "id": int(self.segment_id),
            "next_id": None if self.next_segment_id is None else int(self.next_segment_id),
            "t0": float(self.start_time),
            "t1": float(self.end_time),
            "length": float(self.length),
            "queue_length": float(self.queue_length),
        }


def filter_segments(records: list[SegmentRecord],
                    min_length: float = 0.0) -> list[SegmentRecord]:
    """Fully-traversed, non-internal, long-enough records (in drive order)."""
    return [
        r for r in records
        if r.complete and not r.internal and r.length >= min_length
    ]


def build_reports(records: list[SegmentRecord],
                  min_length: float = 0.0) -> list[Report]:
    """Filter + pair with next segment.

    ``next_segment_id`` is the id of the segment the vehicle drove onto next:
    the following fully-traversed record reached over a time-contiguous run of
    records. Internal connector edges (marked so they do NOT break the pair —
    that is what the flag is for) extend the run; a real gap — chain break,
    unmatched stretch, partial segment — yields None.
    """
    reports: list[Report] = []
    prev_report: Report | None = None   # last reportable record, awaiting next
    cont_end: float | None = None       # where the contiguous run currently ends
    for rec in records:
        reportable = rec.complete and not rec.internal and rec.length >= min_length
        contiguous = (cont_end is not None
                      and abs(rec.start_time - cont_end) < 1e-3)
        if reportable:
            if prev_report is not None and contiguous:
                prev_report.next_segment_id = rec.segment_id
            report = Report(
                segment_id=rec.segment_id,
                next_segment_id=None,
                start_time=rec.start_time,
                end_time=rec.end_time,
                length=rec.length,
                queue_length=rec.queue_length,
            )
            reports.append(report)
            prev_report = report
            cont_end = rec.end_time
        elif rec.internal and rec.complete and contiguous:
            cont_end = rec.end_time     # connector: extend the run
        else:
            prev_report = None          # partial / gap: run broken
            cont_end = None
    return reports


def latest_complete_time(records: list[SegmentRecord]) -> float | None:
    """End time of the last fully-traversed segment, or None.

    The service retains trace points at or after this time in the per-uuid
    cache — they may belong to a segment still in progress.
    """
    times = [r.end_time for r in records if r.complete and not r.internal]
    return max(times) if times else None
