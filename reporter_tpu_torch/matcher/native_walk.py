"""The C edge walk (native/walker.cc) and its record columns.

Counterpart: reporter_tpu/matcher/native_walk.py. One call walks every
decoded trace of a slice (multithreaded in C++) and returns the records as
flat numpy columns; ``materialize_records`` slices them into per-trace
SegmentRecord lists on demand. The records equal the Python walk's
(matcher/segments.build_segments), which the tests hold at tolerance 0.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np

from reporter_tpu_torch.matcher.segments import SegmentRecord
from reporter_tpu_torch.native import build as native_build
from reporter_tpu_torch.tiles.reach import check_rows_ascending
from reporter_tpu_torch.tiles.tileset import TileSet


class RecordColumns(NamedTuple):
    """Flat record columns, one row per SegmentRecord, straight from the C
    walker. Per-record Python objects are built lazily, for consumers that
    index a single trace."""

    trace: np.ndarray         # i32 [N] trace row; nondecreasing as emitted
    #                           by walk_columns (remapped or merged columns
    #                           are re-sorted by api._merge_columns)
    segment_id: np.ndarray    # i64 [N]; -1 ⇒ internal connector
    start_time: np.ndarray    # f64 [N]; -1.0 ⇒ partial
    end_time: np.ndarray      # f64 [N]; -1.0 ⇒ partial
    length: np.ndarray        # f64 [N] meters covered
    queue_length: np.ndarray  # f64 [N] meters queued from the stop line
    internal: np.ndarray      # bool [N]
    way_off: np.ndarray       # i64 [N+1]: way_ids[way_off[r]:way_off[r+1]]
    way_ids: np.ndarray       # i64 [way_off[-1]]

    @property
    def n_records(self) -> int:
        return len(self.trace)


def record_bounds(cols: RecordColumns, n_traces: int) -> np.ndarray:
    """[n_traces+1] row bounds: trace b's records are rows
    [bounds[b], bounds[b+1]). Requires cols.trace nondecreasing."""
    return np.searchsorted(cols.trace, np.arange(n_traces + 1))


def empty_columns() -> RecordColumns:
    return RecordColumns(
        np.empty(0, np.int32), np.empty(0, np.int64), np.empty(0),
        np.empty(0), np.empty(0), np.empty(0), np.empty(0, bool),
        np.zeros(1, np.int64), np.empty(0, np.int64))


def materialize_records(cols: RecordColumns, lo: int = 0,
                        hi: "int | None" = None) -> list[SegmentRecord]:
    """SegmentRecord objects for column rows [lo, hi) (usually one trace),
    converted in bulk with .tolist()."""
    hi = cols.n_records if hi is None else hi
    seg_l = cols.segment_id[lo:hi].tolist()
    t0_l = cols.start_time[lo:hi].tolist()
    t1_l = cols.end_time[lo:hi].tolist()
    len_l = cols.length[lo:hi].tolist()
    queue_l = cols.queue_length[lo:hi].tolist()
    int_l = cols.internal[lo:hi].tolist()
    off_l = cols.way_off[lo:hi + 1].tolist()
    ways_l = cols.way_ids[off_l[0]:off_l[-1]].tolist() if hi > lo else []
    base = off_l[0]
    return [SegmentRecord(
        seg_l[r], ways_l[off_l[r] - base:off_l[r + 1] - base],
        t0_l[r], t1_l[r], len_l[r], bool(int_l[r]), queue_l[r])
        for r in range(hi - lo)]


class NativeWalker:
    """The tile's walk arrays, C-contiguous, and the library handle."""

    def __init__(self, ts: TileSet):
        self._lib = native_build.load()
        self._edge_len = np.ascontiguousarray(ts.edge_len, np.float32)
        self._edge_way = np.ascontiguousarray(ts.edge_way, np.int64)
        self._edge_osmlr = np.ascontiguousarray(ts.edge_osmlr, np.int32)
        self._edge_osmlr_off = np.ascontiguousarray(ts.edge_osmlr_off,
                                                    np.float32)
        self._osmlr_id = np.ascontiguousarray(ts.osmlr_id, np.int64)
        self._osmlr_len = np.ascontiguousarray(ts.osmlr_len, np.float32)
        self._reach_row = np.ascontiguousarray(ts.edge_reach_row, np.int32)
        self._reach_to = np.ascontiguousarray(ts.reach_to, np.int32)
        self._reach_dist = np.ascontiguousarray(ts.reach_dist, np.float32)
        self._reach_next = np.ascontiguousarray(ts.reach_next, np.int32)
        check_rows_ascending(self._reach_to)
        self._m = int(ts.reach_to.shape[1])
        self._threads = min(32, os.cpu_count() or 1)

    def walk(self, edges: np.ndarray, offs: np.ndarray, starts: np.ndarray,
             times: np.ndarray, backward_slack: float,
             ) -> list[list[SegmentRecord]]:
        """edges i32 [B,T] (-1 unmatched), offs f32 [B,T], starts bool [B,T],
        times f64 [B,T] → per-trace record lists."""
        B = edges.shape[0]
        cols = self.walk_columns(edges, offs, starts, times, backward_slack)
        bounds = record_bounds(cols, B)
        return [materialize_records(cols, int(bounds[b]), int(bounds[b + 1]))
                for b in range(B)]

    def walk_columns(self, edges: np.ndarray, offs: np.ndarray,
                     starts: np.ndarray, times: np.ndarray,
                     backward_slack: float) -> RecordColumns:
        """The same walk, the records left as flat columns (trace rows
        nondecreasing, drive order within a trace). The record and way
        buffers grow and the call repeats until everything fits."""
        B, T = edges.shape
        edges = np.ascontiguousarray(edges, np.int32)
        offs = np.ascontiguousarray(offs, np.float32)
        starts = np.ascontiguousarray(starts, np.uint8)
        times = np.ascontiguousarray(times, np.float64)
        # the C walk indexes the tile by these ids and reads [B, T] of each
        if any(a.shape != (B, T) for a in (offs, starts, times)):
            raise ValueError("edges, offs, starts and times must all be "
                             f"[{B}, {T}]")
        if edges.size and int(edges.max()) >= len(self._edge_len):
            raise ValueError(f"edge id {int(edges.max())} outside the tile's "
                             f"{len(self._edge_len)} edges")
        ptr = native_build.ptr
        rec_cap = max(64, 2 * B * max(T // 8, 1))
        way_cap = 8 * rec_cap
        while True:
            rec_trace = np.empty(rec_cap, np.int32)
            rec_seg = np.empty(rec_cap, np.int64)
            rec_t0 = np.empty(rec_cap, np.float64)
            rec_t1 = np.empty(rec_cap, np.float64)
            rec_len = np.empty(rec_cap, np.float64)
            rec_queue = np.empty(rec_cap, np.float64)
            rec_internal = np.empty(rec_cap, np.uint8)
            way_off = np.empty(rec_cap + 1, np.int32)
            way_ids = np.empty(way_cap, np.int64)
            n_ways = ctypes.c_int64(0)

            n = self._lib.reporter_walk_segments(
                ptr(edges, ctypes.c_int32), ptr(offs, ctypes.c_float),
                ptr(starts, ctypes.c_uint8), ptr(times, ctypes.c_double),
                B, T,
                ptr(self._edge_len, ctypes.c_float),
                ptr(self._edge_way, ctypes.c_int64),
                ptr(self._edge_osmlr, ctypes.c_int32),
                ptr(self._edge_osmlr_off, ctypes.c_float),
                ptr(self._osmlr_id, ctypes.c_int64),
                ptr(self._osmlr_len, ctypes.c_float),
                ptr(self._reach_row, ctypes.c_int32),
                ptr(self._reach_to, ctypes.c_int32),
                ptr(self._reach_dist, ctypes.c_float),
                ptr(self._reach_next, ctypes.c_int32), self._m,
                float(backward_slack), self._threads,
                ptr(rec_trace, ctypes.c_int32), ptr(rec_seg, ctypes.c_int64),
                ptr(rec_t0, ctypes.c_double), ptr(rec_t1, ctypes.c_double),
                ptr(rec_len, ctypes.c_double),
                ptr(rec_queue, ctypes.c_double),
                ptr(rec_internal, ctypes.c_uint8), rec_cap,
                ptr(way_off, ctypes.c_int32), ptr(way_ids, ctypes.c_int64),
                way_cap, ctypes.byref(n_ways))
            if n <= rec_cap and n_ways.value <= way_cap:
                break
            rec_cap = max(rec_cap * 2, int(n) + 64)
            way_cap = max(way_cap * 2, int(n_ways.value) + 64)

        n = int(n)
        nw = int(way_off[n]) if n else 0
        # .copy(): trimmed views would pin the oversized buffers
        return RecordColumns(
            rec_trace[:n].copy(), rec_seg[:n].copy(), rec_t0[:n].copy(),
            rec_t1[:n].copy(), rec_len[:n].copy(), rec_queue[:n].copy(),
            rec_internal[:n].astype(bool),
            way_off[:n + 1].astype(np.int64), way_ids[:nw].copy())
