"""Edge walk + OSMLR association: matched points → segment records.

Counterpart: reporter_tpu/matcher/segments.py (the exact-parity Python
walk). The Viterbi output (per-point edge/offset) is expanded to the full
driven edge path through the reach tables' next hops, path distances are
mapped to times by linear interpolation between GPS timestamps, and
maximal runs of edges that share an OSMLR row become one record each:
segment_id, way_ids, start_time, end_time, length, internal, queue_length.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np

from reporter_tpu_torch.tiles.tileset import TileSet

# route_fn(e1, e2) → intermediate edge ids strictly between e1 and e2 on the
# matched path, or None when e2 is unreachable (forces a path break).
RouteFn = Callable[[int, int], "list[int] | None"]

# Minimum observed span (m) for a record to exist: one wire offset quantum
# (ops.match.OFFSET_QUANTUM); the JAX package's native walker uses the same.
MIN_RECORD_SPAN = 0.25

# Queue dwell model: movement slower than QUEUE_SPEED averaged over a
# QUEUE_WINDOW trailing span counts as queued traffic. The window absorbs
# the plateau-then-pulse shape of matched queue points (the decoder snaps
# creeping points onto one candidate offset, then jumps ~10 m at once —
# adjacent-pair speeds misread the jump as free flow).
QUEUE_SPEED = 2.0    # m/s (~7 km/h stop-and-go creep)
QUEUE_WINDOW = 10.0  # seconds of trailing window for the speed average


@dataclass
class SegmentRecord:
    """One (possibly partial) OSMLR segment traversal."""

    segment_id: int          # stable OSMLR id (osmlr_id[row])
    way_ids: list[int]       # source way ids along the traversal, in order
    start_time: float        # -1.0 ⇒ entered before this trace (partial)
    end_time: float          # -1.0 ⇒ exit not observed yet (partial)
    length: float            # meters of the segment covered by this traversal
    internal: bool           # True for unassociated connector edges
    queue_length: float = 0.0  # meters of queued (sub-QUEUE_SPEED) traffic
    #                            backed up from the segment end (_queue_length)

    @property
    def complete(self) -> bool:
        return self.start_time >= 0.0 and self.end_time >= 0.0

    def to_json(self) -> dict:
        return {
            "segment_id": int(self.segment_id),
            "way_ids": [int(w) for w in self.way_ids],
            "start_time": float(self.start_time),
            "end_time": float(self.end_time),
            "length": float(self.length),
            "internal": bool(self.internal),
            "queue_length": float(self.queue_length),
        }


@dataclass
class MatchedChain:
    """One breakage-free run of matched points (host-side)."""

    edges: list[int]         # per matched point
    offsets: list[float]
    times: list[float]


def reach_route_fn(ts: TileSet) -> RouteFn:
    """RouteFn that walks the precomputed reach_next tables."""

    def route(e1: int, e2: int) -> list[int] | None:
        if e1 == e2:
            return []
        chain: list[int] = []
        e = e1
        gap = np.inf
        while True:
            u = int(ts.edge_reach_row[e])   # edge → governing reach row
            row = ts.reach_to[u]
            hit = np.nonzero(row == e2)[0]
            if not len(hit):
                return None
            new_gap = float(ts.reach_dist[u, hit[0]])
            if new_gap >= gap:  # no progress ⇒ inconsistent tables; bail out
                return None
            gap = new_gap
            nxt = int(ts.reach_next[u, hit[0]])
            if nxt == e2:
                return chain
            if nxt < 0:
                return None
            chain.append(nxt)
            e = nxt

    return route


def _chain_to_path(ts: TileSet, chain: MatchedChain, route_fn: RouteFn,
                   backward_slack: float):
    """Expand a matched chain to (edge path, per-point path distance).

    Path distance d is measured from the start of the first edge; point i sits
    at d = (sum of lengths of path edges before its edge) + offset_i.
    A routing failure splits the chain — yields multiple (path, pts) tuples.
    """
    out = []
    path: list[int] = [chain.edges[0]]
    cum: list[float] = [0.0]          # path-distance at start of path[i]
    pts: list[tuple[float, float]] = [(chain.offsets[0], chain.times[0])]

    def flush():
        nonlocal path, cum, pts
        if path and pts:
            out.append((path, pts))
        path, cum, pts = [], [], []

    for i in range(1, len(chain.edges)):
        e_prev, e_cur = chain.edges[i - 1], chain.edges[i]
        off, t = chain.offsets[i], chain.times[i]
        if e_cur == e_prev and off >= chain.offsets[i - 1] - backward_slack:
            d = cum[-1] + max(off, pts[-1][0] - cum[-1])  # monotone clamp
            pts.append((d, t))
            continue
        mid = route_fn(e_prev, e_cur)
        if mid is None:
            flush()
            path = [e_cur]
            cum = [0.0]
            pts = [(off, t)]
            continue
        for m in [*mid, e_cur]:
            cum.append(cum[-1] + float(ts.edge_len[path[-1]]))
            path.append(m)
        pts.append((cum[-1] + off, t))
    flush()
    return out


def _time_at(pts: list[tuple[float, float]], d: float) -> float:
    """Linear time interpolation at path distance d; -1.0 outside the span."""
    if not pts or d < pts[0][0] - 1e-6 or d > pts[-1][0] + 1e-6:
        return -1.0
    ds = [p[0] for p in pts]
    i = int(np.searchsorted(ds, d))
    i = max(1, min(i, len(pts) - 1))
    d0, t0 = pts[i - 1]
    d1, t1 = pts[i]
    if d1 <= d0 + 1e-9:
        return float(t0)
    w = (d - d0) / (d1 - d0)
    return float(t0 + w * (t1 - t0))


def build_segments(ts: TileSet, chains: Iterable[MatchedChain],
                   route_fn: RouteFn, backward_slack: float = 10.0,
                   ) -> list[SegmentRecord]:
    """OSMLR segment records for all chains of one trace, in drive order."""
    records: list[SegmentRecord] = []
    for chain in chains:
        if not chain.edges:
            continue
        for path, pts in _chain_to_path(ts, chain, route_fn, backward_slack):
            records.extend(_path_to_records(ts, path, pts))
    return records


def _queue_length(pts: list[tuple[float, float]], d_tail: float,
                  seg_len: float) -> float:
    """Dwell-at-the-stop-line queue model (reference `queue_length` field).

    The reference derives queue signal from probe dwell near segment ends
    (SURVEY.md §2.2 row 1, §0 item 5): vehicles creeping toward a signal at
    the end of a segment reveal the queue backed up from the stop line. Walk
    consecutive matched-point movements backward from the segment tail (path
    distance ``d_tail``); while each pair moves slower than QUEUE_SPEED the
    queue extends back to the earlier point. Returns the distance from the
    segment end to the upstream end of the slow run, clamped to the segment.

    A point extends the queue when the average speed from it to the point
    QUEUE_WINDOW seconds later (capped at the anchor) stays below
    QUEUE_SPEED — tested as ``dd < QUEUE_SPEED * dt`` (no division, so
    dt<=0 spans are never slow).
    """
    # Anchor at the LAST point at/before the tail: dwell is evidence about
    # the approach to the stop line — a point past it is already back in
    # free flow and would mask the queue. Point distances are monotone
    # (the walker clamps them), so bisect instead of a linear scan.
    i = max(0, bisect.bisect_right(pts, d_tail + 1e-6,
                                   key=lambda p: p[0]) - 1)
    q_start = d_tail
    j = i          # window end: min index with time >= cand time + WINDOW
    k = i
    while k >= 1:
        cand = k - 1
        while j > cand + 1 and pts[j - 1][1] - pts[cand][1] >= QUEUE_WINDOW:
            j -= 1
        dd = pts[j][0] - pts[cand][0]
        dt = pts[j][1] - pts[cand][1]
        if not dd < QUEUE_SPEED * dt:
            break
        q_start = pts[cand][0]
        k = cand
    return min(max(d_tail - q_start, 0.0), seg_len)


def _path_to_records(ts: TileSet, path: list[int],
                     pts: list[tuple[float, float]]) -> list[SegmentRecord]:
    # cum[i] = path distance at start of path[i]
    cum = np.concatenate([[0.0], np.cumsum(ts.edge_len[path].astype(np.float64))])
    observed_lo, observed_hi = pts[0][0], pts[-1][0]

    records: list[SegmentRecord] = []
    i = 0
    while i < len(path):
        row = int(ts.edge_osmlr[path[i]])
        j = i
        # maximal run of edges on the same OSMLR row with contiguous offsets
        while (j + 1 < len(path)
               and int(ts.edge_osmlr[path[j + 1]]) == row
               and (row < 0 or abs(
                   float(ts.edge_osmlr_off[path[j + 1]])
                   - (float(ts.edge_osmlr_off[path[j]])
                      + float(ts.edge_len[path[j]]))) < 1.0)):
            j += 1
        d_lo, d_hi = float(cum[i]), float(cum[j + 1])
        # clip to the observed span: beyond it there is no time basis at all
        c_lo, c_hi = max(d_lo, observed_lo), min(d_hi, observed_hi)
        # Spans below the wire offset quantum (0.25 m, ops/match.py) are not
        # representable device-side and are pure float noise against 4 m GPS
        # sigma; emitting them makes backends diverge on boundary slivers.
        if c_hi > c_lo + MIN_RECORD_SPAN:
            way_ids: list[int] = []
            for e in path[i:j + 1]:
                w = int(ts.edge_way[e])
                if not way_ids or way_ids[-1] != w:
                    way_ids.append(w)
            if row < 0:
                records.append(SegmentRecord(
                    segment_id=-1, way_ids=way_ids,
                    start_time=_time_at(pts, c_lo), end_time=_time_at(pts, c_hi),
                    length=c_hi - c_lo, internal=True))
            else:
                o_start = float(ts.edge_osmlr_off[path[i]])
                seg_len = float(ts.osmlr_len[row])
                # full traversal needs the segment's own [0, seg_len] covered
                covered_lo = o_start + (c_lo - d_lo)
                covered_hi = o_start + (c_hi - d_lo)
                starts_at_origin = covered_lo <= 1.0
                ends_at_tail = covered_hi >= seg_len - 1.0
                # Queue needs the stop line observed: only tail-reaching
                # records carry dwell evidence about the segment end.
                queue = (_queue_length(pts, d_lo + (seg_len - o_start), seg_len)
                         if ends_at_tail else 0.0)
                records.append(SegmentRecord(
                    segment_id=int(ts.osmlr_id[row]), way_ids=way_ids,
                    start_time=_time_at(pts, c_lo) if starts_at_origin else -1.0,
                    end_time=_time_at(pts, c_hi) if ends_at_tail else -1.0,
                    length=covered_hi - covered_lo, internal=False,
                    queue_length=queue))
        i = j + 1
    return records
