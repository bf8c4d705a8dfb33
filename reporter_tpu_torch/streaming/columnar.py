"""Columnar streaming ingest: the firehose path.

Counterpart: reporter_tpu/streaming/columnar.py. The dict StreamPipeline
(streaming/pipeline.py) handles every record as a Python dict through
poll, consume, flush and report build; this module runs the same
pipeline semantics over numpy record batches end to end:

  ProbeColumns            one batch of probes as flat columns
  ColumnarIngestQueue     partitioned offset log storing column batches
                          (ProbeConsumer-compatible through a dict poll)
  ColumnarTraceCache      per-uuid trailing points as arrays (the
                          PartialTraceCache semantics, columnar storage)
  ColumnarStreamPipeline  consume, flush, report, histogram with no
                          per-record Python: uuid interning at np.unique
                          granularity, per-code counters, one lonlat-to-xy
                          conversion per wave, the matcher's columnar
                          MatchBatch, the native report build
                          (native_prepare.build_reports) and tail cuts
                          (native_prepare.tail_cuts)

The match runs on the port's SegmentMatcher on ``device`` (``cuda``
unless the caller passes ``device="cpu"``); the speed and queue
histograms stay there (streaming/histogram.py). With ``pipeline_depth``
>= 1 the match runs on a one-thread executor while the main loop
consumes, and the publisher thread POSTs. Reports, histograms, commit
floors, malformed counts, cache contents and the checkpoint format equal
the dict pipeline's on the same stream and the JAX package's, at
tolerance 0 (tests/test_torch_streaming_columnar.py).
"""

from __future__ import annotations

import bisect
import time
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from reporter_tpu_torch.utils import locks
from reporter_tpu_torch.config import Config
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.matcher.api import (DispatchTimeout, MatchBatch,
                                      SegmentMatcher, Trace)
from reporter_tpu_torch.service.datastore import DatastorePublisher, Transport
from reporter_tpu_torch.streaming.histogram import SpeedHistogram
from reporter_tpu_torch.streaming.queue import partition_of
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils import tracing


# ---------------------------------------------------------------------------
# Probe batches


class ProbeColumns(NamedTuple):
    """One batch of canonical probe records as flat columns. NaN marks an
    absent time/accuracy (the canonical dict shape simply omits the key)."""

    uuid: np.ndarray       # str_ [N]
    lat: np.ndarray        # f64 [N]
    lon: np.ndarray        # f64 [N]
    time: np.ndarray       # f64 [N]; NaN ⇒ absent (index seconds assigned)
    accuracy: np.ndarray   # f32 [N]; NaN ⇒ absent

    @property
    def n(self) -> int:    # NamedTuple.__len__ is the field count
        return len(self.lat)

    def rows(self, idx) -> "ProbeColumns":
        return ProbeColumns(*(a[idx] for a in self))


def empty_probe_columns() -> ProbeColumns:
    return ProbeColumns(np.empty(0, np.str_), np.empty(0), np.empty(0),
                        np.empty(0), np.empty(0, np.float32))


def pack_records(records: Sequence[dict]) -> ProbeColumns:
    """Canonical record dicts → one column batch (compatibility path for
    dict producers; columnar producers build ProbeColumns directly)."""
    n = len(records)
    uuid = np.array([str(r.get("uuid", "")) for r in records])
    lat = np.full(n, np.nan)
    lon = np.full(n, np.nan)
    t = np.full(n, np.nan)
    acc = np.full(n, np.nan, np.float32)
    for i, r in enumerate(records):
        try:
            lat[i] = float(r["lat"])
            lon[i] = float(r["lon"])
        except (KeyError, TypeError, ValueError):
            continue                      # row stays NaN ⇒ malformed
        if "time" in r:
            try:
                tv = float(r["time"])
            except (TypeError, ValueError):
                lat[i] = np.nan           # dict pipeline treats a bad
                continue                  # time as a poison record
            if not np.isfinite(tv):
                lat[i] = np.nan           # explicit NaN/inf time is poison
                continue                  # too — NaN in the column means
            t[i] = tv                     # "key absent", never "bad value"
        if "accuracy" in r:
            try:
                av = float(r["accuracy"])
            except (TypeError, ValueError):
                av = np.nan               # advisory field: drop it, keep
                                          # the point (dict-path parity)
            if np.isfinite(av):
                acc[i] = av               # non-finite = dropped too: an
                                          # inf weight would wedge the
                                          # dict flush validator
    if n and uuid.dtype == object:
        uuid = uuid.astype(np.str_)
    return ProbeColumns(uuid, lat, lon, t, acc)


# ---------------------------------------------------------------------------
# Columnar broker


class ColumnarIngestQueue:
    """Partitioned offset log whose unit of storage is a column batch.

    Offset semantics are identical to IngestQueue (dense per-partition
    offsets, replayable, LookupError below the retention floor —
    streaming/broker.py); ``poll`` materializes dicts for per-record
    consumers, ``poll_batch`` hands column slices to the columnar
    pipeline without touching Python objects per record.

    ``max_records_per_partition`` bounds the RETAINED backlog (end −
    retention floor) so a producer that outruns the consumer cannot grow
    RSS without bound. Overload is an explicit, COUNTED policy, never a
    silent one:

      "reject"       producer-side shedding: rows over the bound are
                     refused at append (``append_columns`` returns the
                     accepted count; ``rejected`` counts the rest) — the
                     broker keeps every record it ever acked.
      "drop_oldest"  consumer-side shedding: the append is taken and the
                     OLDEST whole batches are aged out, the retention
                     floor advancing past them (``dropped_oldest``
                     counts the rows). A consumer polling below the new
                     floor gets the protocol's LookupError; the pipeline
                     skips to the floor and counts the gap (``overrun``).
    """

    def __init__(self, num_partitions: int = 4,
                 max_records_per_partition: "int | None" = None,
                 overload_policy: str = "reject"):
        self.num_partitions = int(num_partitions)
        if overload_policy not in ("reject", "drop_oldest"):
            raise ValueError(f"unknown overload_policy {overload_policy!r};"
                             " use 'reject' or 'drop_oldest'")
        self.max_records_per_partition = (
            None if max_records_per_partition is None
            else int(max_records_per_partition))
        if (self.max_records_per_partition is not None
                and self.max_records_per_partition < 1):
            raise ValueError("max_records_per_partition must be >= 1")
        self.overload_policy = overload_policy
        self.rejected = 0          # rows refused at append ("reject")
        self.dropped_oldest = 0    # rows aged out past the floor
        # per partition: parallel lists of batch base offsets and batches
        self._bases: list[list[int]] = [[] for _ in range(self.num_partitions)]
        self._batches: list[list[ProbeColumns]] = [
            [] for _ in range(self.num_partitions)]
        self._end = [0] * self.num_partitions
        self._floor = [0] * self.num_partitions
        self._lock = locks.named_lock("broker.partitions")

    # ---- producer surface ----------------------------------------------

    def append_columns(self, cols: ProbeColumns) -> int:
        """Route a batch's rows to uuid-hash partitions (vectorized at
        unique-uuid granularity) and append one sub-batch per partition.
        Returns the number of rows ACCEPTED (== cols.n unless a partition
        bound rejected the overflow)."""
        if not cols.n:
            return 0
        uniq, inv = np.unique(cols.uuid, return_inverse=True)
        pu = np.array([partition_of(str(u), self.num_partitions)
                       for u in uniq], np.int32)
        prow = pu[inv]
        bound = self.max_records_per_partition
        accepted = 0
        with self._lock:
            for p in range(self.num_partitions):
                idx = np.nonzero(prow == p)[0]
                if not len(idx):
                    continue
                if bound is not None and self.overload_policy == "reject":
                    room = bound - (self._end[p] - self._floor[p])
                    if room < len(idx):
                        self.rejected += len(idx) - max(0, room)
                        if room <= 0:
                            continue
                        idx = idx[:room]
                sub = cols.rows(idx)
                # durability hook BEFORE the in-memory append, so on-disk
                # batch order always matches offset order (same discipline
                # as IngestQueue._persist)
                self._persist_batch(p, sub)
                self._bases[p].append(self._end[p])
                self._batches[p].append(sub)
                self._end[p] += len(idx)
                accepted += len(idx)
                if bound is not None and self.overload_policy == "drop_oldest":
                    self._shed_oldest(p, bound)
        return accepted

    def _shed_oldest(self, p: int, bound: int) -> None:
        """Age out whole oldest batches until the partition fits its bound
        (the just-appended batch is never shed: a single over-bound batch
        is retained whole — the bound is enforced at batch granularity).
        Runs under the lock."""
        bases, batches = self._bases[p], self._batches[p]
        shed = False
        while (len(bases) > 1
               and self._end[p] - self._floor[p] > bound):
            b = batches[0]
            self.dropped_oldest += b.n - max(0, self._floor[p] - bases[0])
            del bases[0], batches[0]
            self._floor[p] = bases[0]
            shed = True
        if shed:
            self._persist_truncate(p)

    def overload_stats(self) -> dict:
        """Counted shedding outcomes for /stats surfaces."""
        with self._lock:
            return {"broker_policy": self.overload_policy,
                    "broker_bound": self.max_records_per_partition,
                    "broker_rejected": int(self.rejected),
                    "broker_dropped_oldest": int(self.dropped_oldest)}

    def _persist_batch(self, p: int, cols: ProbeColumns) -> None:
        """Durability hook (DurableColumnarIngestQueue). No-op in-proc."""

    def append(self, record: dict) -> None:
        self.append_columns(pack_records([record]))

    def append_many(self, records: Sequence[dict]) -> None:
        self.append_columns(pack_records(records))

    # ---- consumer surface ----------------------------------------------

    def poll_batch(self, partition: int, offset: int, max_records: int,
                   ) -> "list[tuple[int, ProbeColumns]]":
        """Column slices covering [offset, offset+max_records), in offset
        order: [(base_offset, columns)…]."""
        with self._lock:
            if offset < self._floor[partition]:
                raise LookupError(
                    f"offset {offset} below retention floor "
                    f"{self._floor[partition]} (partition {partition})")
            bases = self._bases[partition]
            batches = self._batches[partition]
            out: list[tuple[int, ProbeColumns]] = []
            k = bisect.bisect_right(bases, offset) - 1
            if k < 0:
                k = 0
            left = max_records
            while k < len(bases) and left > 0:
                base, b = bases[k], batches[k]
                lo = max(0, offset - base)
                hi = min(b.n, lo + left)
                if lo < hi:
                    sl = b if (lo == 0 and hi == b.n) else b.rows(
                        slice(lo, hi))
                    out.append((base + lo, sl))
                    left -= hi - lo
                k += 1
            return out

    def poll(self, partition: int, offset: int,
             max_records: int) -> "list[tuple[int, dict]]":
        """Per-record compatibility shim (ProbeConsumer protocol). Only
        NaN means "key absent"; a ±inf time/accuracy from a direct
        columnar producer must materialize AS inf so the dict consumer's
        validator rejects it exactly like the columnar consumer does —
        mapping it to an absent key would launder a poison value into a
        valid timeless record and fork the malformed counts."""
        out: list[tuple[int, dict]] = []
        for base, cols in self.poll_batch(partition, offset, max_records):
            for i in range(cols.n):
                rec = {"uuid": str(cols.uuid[i]), "lat": float(cols.lat[i]),
                       "lon": float(cols.lon[i])}
                if not np.isnan(cols.time[i]):
                    rec["time"] = float(cols.time[i])
                if not np.isnan(cols.accuracy[i]):
                    rec["accuracy"] = float(cols.accuracy[i])
                out.append((base + i, rec))
        return out

    def end_offset(self, partition: int) -> int:
        with self._lock:
            return self._end[partition]

    def retention_floor(self, partition: int) -> int:
        """Oldest pollable offset (consumers skip here after an overrun
        LookupError — the Kafka auto.offset.reset=earliest analog)."""
        with self._lock:
            return self._floor[partition]

    def lag(self, committed: Sequence[int]) -> int:
        return sum(self.end_offset(p) - committed[p]
                   for p in range(self.num_partitions))

    def truncate(self, committed: Sequence[int]) -> None:
        """Drop whole batches entirely below the committed offsets. The
        retention floor advances to the first RETAINED offset (a batch
        straddling the commit keeps its early rows pollable)."""
        with self._lock:
            for p, off in enumerate(committed):
                bases, batches = self._bases[p], self._batches[p]
                k = 0
                while k < len(bases) and bases[k] + batches[k].n <= off:
                    k += 1
                if k:
                    self._bases[p] = bases[k:]
                    self._batches[p] = batches[k:]
                new_floor = (self._bases[p][0] if self._bases[p]
                             else min(off, self._end[p]))
                if new_floor > self._floor[p]:
                    self._floor[p] = new_floor
                    self._persist_truncate(p)

    def _persist_truncate(self, p: int) -> None:
        """Durability hook: rewrite partition p's backing store to match
        the truncated in-memory state. Runs under the lock. No-op
        in-proc."""


# ---------------------------------------------------------------------------
# Columnar per-uuid tail cache


class _TailEntry:
    __slots__ = ("lat", "lon", "time", "acc", "wall", "last")

    def __init__(self, lat, lon, time_, acc, wall, last=None):
        self.lat, self.lon, self.time, self.acc = lat, lon, time_, acc
        self.wall = wall
        # last timestamp as a PYTHON float: merge_wave's append-vs-dedup
        # test runs per vehicle per wave, and a numpy scalar read there
        # costs more than the comparison itself
        self.last = float(time_[-1]) if last is None else last


class ColumnarTraceCache:
    """PartialTraceCache semantics (TTL + LRU + straddling-tail retention,
    service/cache.py) with the per-uuid points stored as numpy arrays.
    dump()/load() speak the dict cache's checkpoint schema, so a
    checkpoint written by either pipeline restores into the other."""

    def __init__(self, ttl: float = 60.0, max_uuids: int = 100_000,
                 max_points: int = 256, clock=time.monotonic):
        from collections import OrderedDict

        self.ttl = float(ttl)
        self.max_uuids = int(max_uuids)
        self.max_points = int(max_points)
        self._clock = clock
        self._entries: "OrderedDict[str, _TailEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def tail(self, uuid: str,
             now: "float | None" = None) -> "_TailEntry | None":
        """The live cached tail (TTL-checked; a stale entry is dropped
        on read) — THE lookup-and-expire rule, shared by merge() and
        merge_wave (which hoists one clock read per wave via ``now``)."""
        e = self._entries.get(uuid)
        if e is not None:
            if now is None:
                now = self._clock()
            if now - e.wall > self.ttl:
                del self._entries[uuid]
                e = None
        return e

    def _merge_overlap(self, e: _TailEntry, lat, lon, time_, acc):
        """The dedup branch of merge(): new timestamps overlap the
        cached tail, so filter duplicates and re-sort time-ascending."""
        fresh = ~np.isin(time_, e.time)
        lat = np.concatenate([e.lat, lat[fresh]])
        lon = np.concatenate([e.lon, lon[fresh]])
        t = np.concatenate([e.time, time_[fresh]])
        acc = np.concatenate([e.acc, acc[fresh]])
        order = np.argsort(t, kind="stable")
        return lat[order], lon[order], t[order], acc[order]

    def merge(self, uuid: str, lat, lon, time_, acc):
        """(cached tail ⊕ new rows) deduped by timestamp, time-ascending —
        exactly PartialTraceCache.merge, on arrays. Callers pass new rows
        time-sorted (the pipeline lexsorts the flush), and entries store
        sorted tails, so the common streaming case — every new timestamp
        past the cached tail — is a plain concat with no dedup/sort."""
        e = self.tail(uuid)
        if e is None:
            return lat, lon, time_, acc
        if len(time_) and e.time[-1] < time_[0]:
            return (np.concatenate([e.lat, lat]),
                    np.concatenate([e.lon, lon]),
                    np.concatenate([e.time, time_]),
                    np.concatenate([e.acc, acc]))
        return self._merge_overlap(e, lat, lon, time_, acc)

    def merge_wave(self, uuids: "Sequence[str]", lat, lon, time_, acc,
                   bounds: np.ndarray):
        """Batched merge() over one flush wave: vehicle v's new rows are
        the slice [bounds[v], bounds[v+1]) of the flat columns. Returns
        (lat, lon, time, acc, bounds) of the merged wave — each column
        concatenated ONCE instead of four np.concatenate calls per
        vehicle, which was the prepare stage's top host cost at
        firehose/validation scale. Element-for-element equal to calling
        merge() per vehicle (the common no-tail / append-tail cases are
        pure piece gathering; the rare overlap case reuses the same
        dedup branch)."""
        V = len(uuids)
        pl: list = []
        pn: list = []
        pt: list = []
        pa: list = []
        lens = np.empty(V, np.int64)
        # bulk scalar extraction (ONE .tolist() runs in C; per-vehicle
        # int()/float() of numpy scalars was a measured per-wave cost)
        b_list = bounds.tolist()
        firsts = time_[bounds[:-1]].tolist() if V else []
        now = self._clock()
        for v in range(V):
            lo, hi = b_list[v], b_list[v + 1]
            nl, nn = lat[lo:hi], lon[lo:hi]
            nt, na = time_[lo:hi], acc[lo:hi]
            e = self.tail(uuids[v], now=now)
            if e is None:
                pl.append(nl); pn.append(nn); pt.append(nt); pa.append(na)
                lens[v] = hi - lo
            elif e.last < firsts[v]:
                pl.append(e.lat); pn.append(e.lon)
                pt.append(e.time); pa.append(e.acc)
                pl.append(nl); pn.append(nn); pt.append(nt); pa.append(na)
                lens[v] = len(e.time) + (hi - lo)
            else:
                ml, mn, mt, ma = self._merge_overlap(e, nl, nn, nt, na)
                pl.append(ml); pn.append(mn); pt.append(mt); pa.append(ma)
                lens[v] = len(mt)
        out_bounds = np.zeros(V + 1, np.int64)
        np.cumsum(lens, out=out_bounds[1:])
        return (np.concatenate(pl) if pl else np.empty(0),
                np.concatenate(pn) if pn else np.empty(0),
                np.concatenate(pt) if pt else np.empty(0),
                np.concatenate(pa) if pa else np.empty(0, np.float32),
                out_bounds)

    def retain(self, uuid: str, lat, lon, time_, acc,
               from_time: float) -> None:
        """Keep rows from one before the first time >= from_time (the
        straddling pair rule of PartialTraceCache.retain)."""
        at = np.nonzero(time_ >= from_time)[0]
        cut = max(0, int(at[0]) - 1) if len(at) else max(0, len(time_) - 1)
        lo = max(cut, len(time_) - self.max_points)
        self.retain_cut(uuid, lat, lon, time_, acc, lo)
        self._evict()

    def retain_cut(self, uuid: str, lat, lon, time_, acc,
                   lo: int) -> None:
        """retain() with the cut precomputed (native_prepare.tail_cuts
        batches a whole wave's cuts in one call) and the eviction sweep
        deferred to sweep() — same final cache state, without a
        TTL/capacity scan per vehicle."""
        if lo >= len(time_):
            self._entries.pop(uuid, None)
            return
        self._entries[uuid] = _TailEntry(
            lat[lo:].copy(), lon[lo:].copy(), time_[lo:].copy(),
            acc[lo:].copy(), self._clock())
        self._entries.move_to_end(uuid)

    def retain_wave(self, uuids: "Sequence[str]", lat, lon, time_, acc,
                    bounds: np.ndarray, los: np.ndarray) -> None:
        """Batched retain_cut over a wave's flat merged columns: vehicle
        v retains rows [bounds[v] + los[v], bounds[v+1]). The per-wave
        scalar work (cut arithmetic, last timestamps) is bulk-extracted,
        then each entry gets OWNED contiguous-slice copies — owned, not
        views of a shared block, so a straggler vehicle's entry can
        never pin other vehicles' rows for its TTL lifetime — and ONE
        eviction sweep runs at the end. Final cache state identical to
        per-vehicle retain_cut + sweep."""
        b0, b1 = bounds[:-1], bounds[1:]
        src0 = b0 + los
        keep = np.nonzero(src0 < b1)[0]
        now = self._clock()
        entries = self._entries
        src_list = src0[keep].tolist()
        end_list = b1[keep].tolist()
        last_list = time_[b1[keep] - 1].tolist() if len(keep) else []
        kept = set()
        for k, v in enumerate(keep.tolist()):
            u = uuids[v]
            kept.add(v)
            a, b = src_list[k], end_list[k]
            entries[u] = _TailEntry(
                lat[a:b].copy(), lon[a:b].copy(), time_[a:b].copy(),
                acc[a:b].copy(), now, last=last_list[k])
            entries.move_to_end(u)
        if len(kept) < len(uuids):
            for v, u in enumerate(uuids):
                if v not in kept:       # nothing retained: entry drops
                    entries.pop(u, None)
        self._evict()

    def sweep(self) -> None:
        """The TTL + capacity eviction retain() runs per call, run once
        per wave by the batched retention path."""
        self._evict()

    def dump(self) -> dict:
        now = self._clock()
        out = {}
        for u, e in self._entries.items():
            pts = []
            for i in range(len(e.time)):
                p = {"lat": float(e.lat[i]), "lon": float(e.lon[i]),
                     "time": float(e.time[i])}
                if np.isfinite(e.acc[i]):
                    p["accuracy"] = float(e.acc[i])
                pts.append(p)
            out[u] = {"points": pts, "age": now - e.wall}
        return out

    def load(self, state: dict, extra_age: float = 0.0) -> None:
        now = self._clock()
        self._entries.clear()
        for u, rec in sorted(state.items(), key=lambda kv: -kv[1]["age"]):
            age = float(rec["age"]) + extra_age
            pts = rec["points"]
            if age > self.ttl or not pts:
                continue
            cols = pack_records(pts)
            self._entries[u] = _TailEntry(cols.lat, cols.lon, cols.time,
                                          cols.accuracy, now - age)
        self._evict()

    def _evict(self) -> None:
        now = self._clock()
        while self._entries:
            _, e = next(iter(self._entries.items()))
            if now - e.wall <= self.ttl:
                break
            self._entries.popitem(last=False)
        while len(self._entries) > self.max_uuids:
            self._entries.popitem(last=False)


# ---------------------------------------------------------------------------
# Vectorized report building


def build_report_columns(cols, n_traces: "int | None", min_length: float):
    """service/reports.build_reports, vectorized over RecordColumns.

    The per-record state machine becomes a group-id computation: a chain
    boundary between consecutive records survives iff the records are
    time-adjacent (|t0[r+1] − t1[r]| < 1e-3, within one trace) and the
    next record can carry the run (reportable, or a complete internal
    connector). Records sharing a group id are one unbroken run, so each
    reportable record's ``next_segment_id`` is simply the next reportable
    record in its group. Parity with the scalar builder is test-asserted.

    Returns (seg i64[R], next i64[R] (-1 ⇒ None), t0, t1, length, queue
    f64[R], per_trace_counts i64[n_traces] | None). ``n_traces=None``
    skips the per-trace bincount (the flush hot path doesn't use it).
    """
    n = cols.n_records
    if not n:
        z = np.empty(0, np.int64)
        zf = np.empty(0)
        return z, z, zf, zf, zf, zf, (
            None if n_traces is None else np.zeros(n_traces, np.int64))
    complete = (cols.start_time >= 0.0) & (cols.end_time >= 0.0)
    reportable = complete & ~cols.internal & (cols.length >= min_length)
    carry = reportable | (cols.internal & complete)
    same_trace = cols.trace[1:] == cols.trace[:-1]
    adj = np.abs(cols.start_time[1:] - cols.end_time[:-1]) < 1e-3
    link = same_trace & adj & carry[1:] & carry[:-1]
    group = np.concatenate([[0], np.cumsum(~link)])
    rep = np.nonzero(reportable)[0]
    nxt = np.full(len(rep), -1, np.int64)
    if len(rep) > 1:
        chained = group[rep[1:]] == group[rep[:-1]]
        nxt[:-1][chained] = cols.segment_id[rep[1:][chained]]
    per_trace = (None if n_traces is None else
                 np.bincount(cols.trace[rep],
                             minlength=n_traces).astype(np.int64))
    return (cols.segment_id[rep], nxt, cols.start_time[rep],
            cols.end_time[rep], cols.length[rep], cols.queue_length[rep],
            per_trace)


# ---------------------------------------------------------------------------
# The pipeline


class _Log:
    """Growable columnar buffer of consumed-but-unflushed probe rows.
    ``held`` carries the in-flight wave id (0 = free): a pipelined flush
    marks its rows instead of removing them, so a matcher failure simply
    unmarks them for retry and the commit-floor scan keeps seeing their
    offsets while the wave is on the device."""

    def __init__(self):
        self.n = 0
        self.cap = 0
        self.code = np.empty(0, np.int64)
        self.lat = np.empty(0)
        self.lon = np.empty(0)
        self.time = np.empty(0)
        self.acc = np.empty(0, np.float32)
        self.part = np.empty(0, np.int16)
        self.off = np.empty(0, np.int64)
        self.arrive = np.empty(0)
        self.held = np.empty(0, np.int64)
        self.tless = np.empty(0, bool)   # time was absent: index seconds
        #                                  were assigned (re-based on a
        #                                  failed-wave release)

    _COLS = ("code", "lat", "lon", "time", "acc", "part", "off", "arrive",
             "held", "tless")

    def append(self, **cols) -> None:
        k = len(cols["code"])
        if self.n + k > self.cap:
            self.cap = max(1024, 2 * (self.n + k))
            for f in self._COLS:
                a = getattr(self, f)
                grown = np.empty(self.cap, a.dtype)
                grown[:self.n] = a[:self.n]
                setattr(self, f, grown)
        for f in self._COLS:
            getattr(self, f)[self.n:self.n + k] = cols[f]
        self.n += k

    def compact(self, keep_mask: np.ndarray) -> None:
        k = int(keep_mask.sum())
        for f in self._COLS:
            a = getattr(self, f)
            a[:k] = a[:self.n][keep_mask]
        self.n = k


class _WaveController:
    """Adaptive wave sizing for the pipelined flush loop.

    One number — the effective ``flush_min_points`` — trades per-wave
    overhead (link RTT, dispatch fixed costs: fewer, bigger waves win)
    against probe→report latency (points sit in the buffer until the
    wave fills: smaller waves win). The policy works on the lag TREND,
    not its level (backlog is counted in records, waves in points per
    vehicle — the units don't compare): GROW after STREAK consecutive
    rising-lag updates (the worker is paying too many per-wave overheads
    for the offered rate), SHRINK toward the latency target after STREAK
    non-rising updates with p50 probe→report over target (caught up, so
    buy back latency). The streak hysteresis keeps per-step lag jitter
    from ratcheting the wave. Multiplicative steps, clamped to [lo, hi];
    pure arithmetic so convergence is unit-testable without a pipeline
    (tests/test_torch_streaming_columnar.py)."""

    GROW = 1.3
    SHRINK = 0.85
    STREAK = 3

    def __init__(self, start: int, lo: int, hi: int, target_s: float):
        self.lo, self.hi = int(lo), int(hi)
        self.points = float(min(max(int(start), self.lo), self.hi))
        self.target_s = float(target_s)
        self._rising = 0
        self._steady = 0

    def update(self, lag: int, prev_lag: int,
               last_p50_s: "float | None") -> int:
        if lag > prev_lag * 1.05 + 64:      # real growth, not step jitter
            self._rising += 1
            self._steady = 0
        else:
            self._steady += 1
            self._rising = 0
        if self._rising >= self.STREAK:
            self.points = min(self.hi, self.points * self.GROW)
            self._rising = 0
        elif (self._steady >= self.STREAK and last_p50_s is not None
              and last_p50_s > self.target_s):
            self.points = max(self.lo, self.points * self.SHRINK)
            self._steady = 0
        return int(round(self.points))


class _InflightWave:
    """One flush wave moving through the pipelined loop.

    Until its match result is processed the wave's probe rows stay in the
    log marked ``held=id`` (failure ⇒ unmark + retry, the sequential
    path's match-before-drop discipline); until its publish ATTEMPT
    completes, ``holds`` keeps the commit floor at or below the wave's
    oldest offset, so a checkpoint taken with the wave in flight replays
    it — at-least-once, never lost."""

    __slots__ = ("id", "future", "prep", "uuids", "merged", "merged_flat",
                 "codes", "holds", "arrive", "n_points", "published",
                 "t_prep0", "t_submit", "t_result")

    def __init__(self, wid: int, codes: np.ndarray,
                 holds: "list[tuple[int, int]]", arrive: np.ndarray,
                 n_points: int):
        self.id = wid
        self.future = None
        self.prep = None        # read-ahead ticket → (traces, prepared);
        #                         None once consumed / on the serial arm
        self.uuids: "list[str]" = []
        self.merged: "list[tuple]" = []
        # (lat, lon, time, acc, bounds) flat wave columns — the merged
        # per-vehicle tuples above are views into these; the batched
        # tail-retention path reads the flat form directly
        self.merged_flat: "tuple | None" = None
        self.codes = codes
        self.holds = holds
        self.arrive = arrive
        self.n_points = int(n_points)
        self.published = False      # set by the publisher's on_done
        # latency-attribution timestamps (pipeline clock base): prepare
        # entered / match submitted / match result in hand. Always
        # stamped (three clock() calls per wave); only ACCUMULATED into
        # stage samples when the tracer is enabled. None = not yet
        # stamped — an injected clock may legitimately read 0.0, so the
        # unset sentinel must not be a falsy float.
        self.t_prep0: "float | None" = None
        self.t_submit = 0.0
        self.t_result = 0.0


class ColumnarStreamPipeline:
    """StreamPipeline semantics at columnar speed (see module docstring).

    Public surface mirrors StreamPipeline: step/drain/flush_histograms/
    stats/checkpoint/restore, committed offsets, injectable clock and
    partition ownership; the matcher and histograms on ``device``, or
    the matcher over ``mesh`` (parallel/dp_e2e) and the histograms on its
    first device. The broker should offer ``poll_batch`` (e.g.
    ColumnarIngestQueue); a per-record ProbeConsumer also works through a
    packing shim, at per-record cost on the poll leg only.

    PIPELINED FLUSH (config.streaming.pipeline_depth > 0, the default):
    the three RTT-bearing legs of a flush run concurrently instead of in
    sequence — wave N's device match waits on the link in a one-thread
    executor (GIL released), wave N−1's datastore POST waits on its
    socket in the publisher thread (GIL released), and the main loop
    keeps consuming wave N+1 the whole time. step() submits at most one
    wave and harvests any completed one; drain() joins everything, so
    after drain() the pipelined worker is observably identical to the
    sequential loop (the dict-parity suite runs against exactly this).
    Correctness invariants:

      - a uuid is in at most one unharvested wave (its cache tail is
        retained at harvest; a second merge before that would read stale
        points) — ripe codes of in-flight waves wait;
      - commit floor ≤ the oldest offset of every wave whose publish
        attempt hasn't completed, so checkpoint/crash mid-wave replays
        the wave (at-least-once, never lost);
      - a matcher failure releases the wave's rows for retry, exactly
        like the sequential path's match-before-drop discipline.

    ``streaming.wave_autotune`` adds the adaptive wave-size controller
    (_WaveController) on top; pipeline_depth=0 restores the sequential
    loop.

    Lifecycle: the first pipelined flush lazily starts a one-thread
    executor and the async publisher's worker. Long-lived deployments
    should ``close()`` the pipeline after ``drain()``; a discarded
    pipeline's executor is reclaimed at GC (its idle worker exits via
    the executor's weakref hook) and the publisher thread is a
    daemon."""

    # newest-N bound on the unread latency accumulator (~4 MB of f64):
    # big enough that a drain's take-per-drain() keeps every sample
    # at sane backlogs, small enough that a reader-less production worker
    # neither grows RSS nor pays a growing per-flush concatenate
    _LAT_SAMPLES_CAP = 500_000

    def __init__(self, tileset: TileSet, config: "Config | None" = None,
                 queue=None, transport: "Transport | None" = None,
                 clock=time.monotonic,
                 partitions: "Sequence[int] | None" = None,
                 mesh=None,
                 device: "str | torch.device | None" = None):
        self.config = (config or Config()).validate()
        sc = self.config.streaming
        svc = self.config.service
        self.queue = queue or ColumnarIngestQueue(sc.num_partitions)
        if self.queue.num_partitions != sc.num_partitions:
            raise ValueError("queue/config partition count mismatch")
        owned = range(sc.num_partitions) if partitions is None else partitions
        self.partitions = sorted(set(int(p) for p in owned))
        if any(p < 0 or p >= sc.num_partitions for p in self.partitions):
            raise ValueError(
                f"partitions {self.partitions} out of range "
                f"0..{sc.num_partitions - 1}")
        self.matcher = SegmentMatcher(tileset, self.config, device=device,
                                      mesh=mesh)
        self.cache = ColumnarTraceCache(ttl=svc.cache_ttl,
                                        max_uuids=svc.cache_max_uuids)
        self._depth = int(sc.pipeline_depth)
        from reporter_tpu_torch.service.datastore import publisher_kwargs
        pub_kw = publisher_kwargs(svc, metrics=self.matcher.metrics)
        if self._depth > 0:
            from reporter_tpu_torch.service.datastore import AsyncDatastorePublisher
            self.publisher = AsyncDatastorePublisher(transport=transport,
                                                     **pub_kw)
        else:
            self.publisher = DatastorePublisher(transport=transport,
                                                **pub_kw)
        self.min_segment_length = svc.min_segment_length
        self.clock = clock
        self.committed = [0] * sc.num_partitions
        self._consumed = [0] * sc.num_partitions

        # pipelined-flush state
        self._pool = None                       # lazy 1-thread match executor
        self._inflight: "list[_InflightWave]" = []   # match leg (FIFO)
        self._pending: "list[_InflightWave]" = []    # publish attempt pending
        # pipelined wave PREPARE: with pipeline_prepare on, the
        # pure half of wave prepare (trace build + the matcher's
        # prepared seam) runs on a read-ahead thread while earlier
        # waves occupy the device; stateful steps (cache merge/retain,
        # commit floor, checkpoint) stay on this thread in wave order —
        # wire bytes and report streams are bit-identical to the serial
        # arm (test-asserted).
        self._pp = bool(svc.pipeline_prepare) and self._depth > 0
        self._ra = None                         # lazy read-ahead worker
        self._staged: "list[_InflightWave]" = []   # staged ahead (FIFO),
        #                                            not yet on the device
        self._overlap_hits = 0    # read-ahead builds that overlapped a
        self._overlap_total = 0   # device-occupied window (gauge basis)
        self._wave_serial = 0
        self._wave_ctl = (_WaveController(sc.flush_min_points,
                                          sc.wave_min_points,
                                          sc.wave_max_points,
                                          sc.wave_target_latency)
                          if sc.wave_autotune else None)
        self._wave_points = int(sc.flush_min_points)
        self._prev_lag = 0
        self._last_flush_p50: "float | None" = None
        self.overrun = 0          # records lost to broker drop-oldest shed
        self.dispatch_timeouts = 0   # waves released by the watchdog
        self.waves_completed = 0     # waves fully processed (progress
        #                              signal for the drain stall guard)

        # uuid interning + per-code buffer state
        self._code_of: dict[str, int] = {}
        self._uuid_of: list[str] = []
        self._count = np.zeros(0, np.int64)     # buffered points per code
        self._born = np.zeros(0)                # buffer birth (clock)
        self._log = _Log()

        dev = self.matcher.device
        self.hist = SpeedHistogram(len(tileset.osmlr_id), sc.speed_bins,
                                   device=dev)
        self.qhist = SpeedHistogram(len(tileset.osmlr_id), sc.queue_bins,
                                    device=dev)
        self._osmlr_ids = np.asarray(tileset.osmlr_id)
        self._row_order = np.argsort(self._osmlr_ids, kind="stable")
        self._row_sorted = self._osmlr_ids[self._row_order]
        self._hist_flushed = self.hist.snapshot()
        self._qhist_flushed = self.qhist.snapshot()
        self._hist_flush_at = self.clock()
        self.hist_flushes = 0
        self.steps = 0
        self.malformed = 0
        self.stats_counters = {"traces": 0, "points": 0, "reports": 0,
                               "match_seconds": 0.0, "batches": 0}
        # probe→report latency samples ACCUMULATED since last read (wall
        # seconds from arrival to report build, per flushed probe row);
        # readers take the array and reset to None. Newest-N bounded
        # (_LAT_SAMPLES_CAP) so a reader-less worker stays flat-RSS.
        self.last_flush_latency: "np.ndarray | None" = None

        # span tracing / latency attribution (utils/tracing.py): the
        # PROCESS-GLOBAL recorder, optionally switched on by this
        # pipeline's ServiceConfig. When enabled, each completed wave
        # records its stage spans (broker_dwell → prepare →
        # device_match → report_build (+ publish)) wave-tagged into the
        # flight recorder, and per-probe stage components accumulate for
        # ``take_stage_samples()`` (same take-and-reset + newest-N
        # discipline as last_flush_latency) — the components TELESCOPE:
        # per probe,
        # dwell + prepare + match + build == the last_flush_latency
        # sample exactly, so the attribution reconciles with the
        # measured end-to-end p50 by arithmetic.
        tracing.configure_from_service(svc)
        self._tracer = tracing.tracer()
        # per-WAVE chunk list, concatenated once in take_stage_samples():
        # re-concatenating the accumulated history every completed wave
        # would be O(total^2/wave) memcpy charged to a traced run
        self._stage_chunks: "list[dict[str, np.ndarray]]" = []
        self._stage_count = 0
        self._publish_durs: "list[float]" = []   # per-wave publish
        #                                          enqueue→completion
        #                                          seconds (async leg:
        #                                          INCLUDES publisher
        #                                          queue dwell and
        #                                          retry/backoff — time
        #                                          to durable publish,
        #                                          not one POST's wire
        #                                          time; lands after the
        #                                          e2e cut, reported as
        #                                          its own stage)

    # ---- one poll/flush cycle -------------------------------------------

    def step(self, force_flush: bool = False) -> int:
        if force_flush:
            return self._drain_step()
        sc = self.config.streaming
        n_reports = self._harvest(block=False)
        self._poll_all(sc.poll_max_records)
        now = self.clock()
        ripe = np.nonzero(
            (self._count >= self._wave_points)
            | ((self._count > 0)
               & (now - self._born >= sc.flush_max_age)))[0]
        ripe = self._without_busy(ripe)
        if len(ripe):
            if self._depth == 0:
                n_reports += self._flush(ripe)
            elif self._pp:
                # stage up to ONE wave beyond the device depth: its pure
                # prepare runs on the read-ahead thread while the
                # in-flight waves ride the link
                if (len(self._inflight) + len(self._staged)
                        < self._depth + 1):
                    self._stage_readahead(ripe)
            elif len(self._inflight) < self._depth:
                self._submit_wave(ripe)
        self._promote_staged()
        self._commit()
        self._tick(now)
        self.steps += 1
        return n_reports

    def drain(self) -> int:
        return self.step(force_flush=True)

    def _drain_step(self) -> int:
        """Flush EVERYTHING synchronously (shutdown path): join in-flight
        waves, consume the pollable tail, wave out every buffered point,
        and wait for the publisher — after this the pipelined worker is
        observably identical to the sequential one."""
        sc = self.config.streaming
        self._promote_staged(drain=True)
        n = self._harvest(block=True)
        self._poll_all(sc.poll_max_records)
        stalls = 0
        while True:
            ripe = np.nonzero(self._count > 0)[0]
            if not len(ripe):
                break
            before_to = self.dispatch_timeouts
            before_wc = self.waves_completed
            if self._depth == 0:
                n += self._flush(ripe)
            else:
                if self._pp:
                    if not self._stage_readahead(ripe):
                        break
                    self._promote_staged(drain=True)
                elif not self._submit_wave(ripe):
                    break
                n += self._harvest(block=True)
            if (self.dispatch_timeouts > before_to
                    and self.waves_completed == before_wc):
                # a live loop retries timed-out waves forever; a DRAIN
                # must not — three consecutive rounds with a watchdog
                # trip and ZERO completed waves means the link is gone,
                # and the shutdown path should say so instead of
                # spinning. (A trip alongside completed waves is a
                # flapping link making progress: keep draining.)
                stalls += 1
                if stalls >= 3:
                    raise DispatchTimeout(
                        "drain stalled: device dispatch timed out with "
                        f"no completed waves {stalls} rounds running")
            else:
                stalls = 0
        self.publisher.drain()
        self._commit()
        now = self.clock()
        if (sc.hist_flush_interval > 0
                and now - self._hist_flush_at >= sc.hist_flush_interval):
            self.flush_histograms()
        self.steps += 1
        return n

    def _poll_all(self, max_records: int) -> None:
        from reporter_tpu_torch.streaming.state import poll_with_overrun_skip
        with self._tracer.span("consume"):
            for p in self.partitions:
                batches = poll_with_overrun_skip(self, self._poll_batches,
                                                 p, max_records)
                for offs, cols in batches:
                    self._consume_columns(p, offs, cols)
                    self._consumed[p] = int(offs[-1]) + 1

    def _without_busy(self, ripe: np.ndarray) -> np.ndarray:
        """Codes already in an unharvested wave must wait: their cache
        tails are retained at harvest, so a second merge now would read
        stale points. (Publish-pending waves don't bite — their retains
        already ran.)"""
        busy_waves = self._inflight + self._staged
        if not busy_waves or not len(ripe):
            return ripe
        busy = np.concatenate([w.codes for w in busy_waves])
        return ripe[~np.isin(ripe, busy)]

    def _tick(self, now: float) -> None:
        """Per-step bookkeeping: histogram interval flush, the wave-size
        controller, and observability gauges."""
        sc = self.config.streaming
        if (sc.hist_flush_interval > 0
                and now - self._hist_flush_at >= sc.hist_flush_interval):
            self.flush_histograms()
        lag = sum(self.queue.end_offset(p) - self.committed[p]
                  for p in self.partitions)
        if self._wave_ctl is not None:
            self._wave_points = self._wave_ctl.update(
                lag, self._prev_lag, self._last_flush_p50)
        self._prev_lag = lag
        m = self.matcher.metrics
        m.gauge("stream_lag", lag)
        m.gauge("stream_inflight_waves",
                len(self._inflight) + len(self._pending))
        m.gauge("stream_publish_pending", self.publisher.pending)
        m.gauge("stream_wave_points", self._wave_points)
        if self._pp:
            m.gauge("readahead_depth", len(self._staged))
            total = self._overlap_total
            m.gauge("prepare_overlap_pct",
                    100.0 * self._overlap_hits / total if total else 0.0)

    def _poll_batches(self, p: int, offset: int, max_records: int,
                      ) -> "list[tuple[np.ndarray, ProbeColumns]]":
        """[(per-row offsets i64[N], columns)…]. Offsets are carried
        per row, not as base+arange: the ProbeConsumer contract only
        promises offset ORDER, not density — a broker may skip offsets
        (compacted topics), and assuming density would re-poll past rows
        (duplicate probes) and corrupt the commit floor. A batch broker's
        poll_batch may return either (int base, cols) — declaring its
        batch offsets DENSE, as ColumnarIngestQueue's are by construction
        — or (i64[N] per-row offsets, cols) when they are not."""
        pb = getattr(self.queue, "poll_batch", None)
        if pb is not None:
            return [(base + np.arange(cols.n, dtype=np.int64)
                     if np.ndim(base) == 0 else np.asarray(base, np.int64),
                     cols)
                    for base, cols in pb(p, offset, max_records)]
        pairs = self.queue.poll(p, offset, max_records)   # per-record shim
        if not pairs:
            return []
        return [(np.array([o for o, _ in pairs], np.int64),
                 pack_records([r for _, r in pairs]))]

    # ---- consume ---------------------------------------------------------

    def _consume_columns(self, p: int, offs: np.ndarray,
                         cols: ProbeColumns) -> None:
        now = self.clock()
        # time contract: NaN = key absent (index seconds assigned); ±inf =
        # present-but-non-finite, which the dict pipeline counts malformed
        # at consume (a non-finite time would poison the flush validator)
        ok = (np.char.str_len(np.asarray(cols.uuid, np.str_)) > 0) \
            & np.isfinite(cols.lat) & np.isfinite(cols.lon) \
            & ~np.isinf(cols.time)
        bad = int((~ok).sum())
        if bad:
            self.malformed += bad
            offs = offs[ok]
            cols = cols.rows(ok)
        bad_acc = (cols.accuracy < 0) | np.isinf(cols.accuracy)
        if bad_acc.any():
            # advisory field: a negative or non-finite accuracy is
            # dropped, not the point (formatter + dict-consume behavior;
            # an inf here would become a 1.8e308 matcher weight via
            # nan_to_num at flush)
            cols = cols._replace(accuracy=np.where(
                bad_acc, np.nan, cols.accuracy))
        if not cols.n:
            return

        # intern uuids at unique granularity (the only per-string work)
        uniq, inv = np.unique(cols.uuid, return_inverse=True)
        ucodes = np.empty(len(uniq), np.int64)
        for i, u in enumerate(uniq):
            s = str(u)
            c = self._code_of.get(s)
            if c is None:
                c = len(self._uuid_of)
                self._code_of[s] = c
                self._uuid_of.append(s)
            ucodes[i] = c
        if len(self._uuid_of) > len(self._count):
            grow = len(self._uuid_of)
            cnt = np.zeros(grow, np.int64)
            cnt[:len(self._count)] = self._count
            brn = np.zeros(grow)
            brn[:len(self._born)] = self._born
            self._count, self._born = cnt, brn
        codes = ucodes[inv]

        # per-row ordinal within this batch's per-code groups (stable):
        # timeless rows get index seconds = prior buffered count + ordinal,
        # matching the dict pipeline's per-record len(buf.points)
        t = cols.time.copy()
        nan = ~np.isfinite(t)
        if nan.any():
            order = np.argsort(codes, kind="stable")
            sorted_codes = codes[order]
            starts = np.nonzero(np.concatenate(
                [[True], sorted_codes[1:] != sorted_codes[:-1]]))[0]
            within = np.arange(cols.n, dtype=np.int64)
            within -= np.repeat(starts, np.diff(
                np.concatenate([starts, [cols.n]])))
            ordinal = np.empty(cols.n, np.int64)
            ordinal[order] = within
            t[nan] = (self._count[codes] + ordinal)[nan].astype(np.float64)

        fresh = self._count[ucodes] == 0
        self._born[ucodes[fresh]] = now
        np.add.at(self._count, codes, 1)

        self._log.append(code=codes, lat=cols.lat, lon=cols.lon, time=t,
                         acc=cols.accuracy, part=np.full(cols.n, p, np.int16),
                         off=offs, arrive=np.full(cols.n, now),
                         held=np.zeros(cols.n, np.int64), tless=nan)

    # ---- flush -----------------------------------------------------------

    def _stage_wave(self, ripe_codes: np.ndarray,
                    ) -> "_InflightWave | None":
        """STATEFUL half of wave prepare (pipeline thread ONLY): select
        the ripe rows, merge cache tails in wave order, compute the
        commit-floor holds, and mark the rows held=wave-id. Everything
        the next wave's selection or the commit floor can observe
        happens here — which is what lets ``_build_traces`` run on a
        read-ahead thread without reordering any stateful step."""
        t_prep0 = self.clock()
        L = self._log
        # direct lookup, not np.isin: codes are dense interned ints, so a
        # boolean table is one O(n) gather (isin re-sorts per wave)
        ripe_lut = np.zeros(len(self._count), bool)
        ripe_lut[ripe_codes] = True
        mask = ripe_lut[L.code[:L.n]] & (L.held[:L.n] == 0)
        rows = np.nonzero(mask)[0]
        if not len(rows):
            return None
        # ONE stable (code, time) lexsort orders every flushed vehicle's
        # slice time-ascending at once — the dict path's _validate_payload
        # sorts every payload before the cache merge, and parity requires
        # the same point order into the matcher (a per-vehicle argsort
        # here was the top host cost at firehose rates).
        order = rows[np.lexsort((L.time[rows], L.code[rows]))]
        codes_sorted = L.code[order]
        starts = np.nonzero(np.concatenate(
            [[True], codes_sorted[1:] != codes_sorted[:-1]]))[0]
        bounds = np.concatenate([starts, [len(order)]])

        # ONE gather per column, then per-vehicle contiguous views — the
        # per-vehicle fancy-index gathers + concats this replaces were
        # the prepare stage's top host cost at validation scale
        lat_w = L.lat[order]
        lon_w = L.lon[order]
        t_w = L.time[order]
        acc_w = L.acc[order]
        uuids = [self._uuid_of[int(codes_sorted[s])] for s in starts]
        lat_m, lon_m, t_m, acc_m, mb = self.cache.merge_wave(
            uuids, lat_w, lon_w, t_w, acc_w, bounds)

        # commit-floor holds + arrival copy, then mark the rows held
        parts = L.part[rows]
        offs = L.off[rows]
        holds = [(int(p), int(offs[parts == p].min()))
                 for p in np.unique(parts)]
        self._wave_serial += 1
        # codes_sorted is sorted, so its run starts ARE the unique codes
        wave = _InflightWave(self._wave_serial, codes_sorted[starts],
                             holds, L.arrive[rows].copy(),
                             n_points=int(mb[-1]))
        wave.uuids = uuids
        wave.merged_flat = (lat_m, lon_m, t_m, acc_m, mb)
        wave.t_prep0 = t_prep0
        L.held[rows] = wave.id
        self._count[ripe_codes] = 0
        return wave

    def _build_traces(self, wave: "_InflightWave") -> list:
        """PURE half of wave prepare: lonlat→xy + accuracy cleaning +
        matcher Trace construction from the wave's already-merged flat
        columns. Reads only the wave and immutable tileset metadata —
        safe on the read-ahead thread while later waves stage."""
        lat_m, lon_m, t_m, acc_m, mb = wave.merged_flat
        uuids = wave.uuids

        # one lonlat→xy conversion for every flushed point
        n_pts = wave.n_points
        lonlat = np.empty((n_pts, 2))
        lonlat[:, 0] = lon_m
        lonlat[:, 1] = lat_m
        xy = lonlat_to_xy(lonlat, np.asarray(
            self.matcher.ts.meta.origin_lonlat)).astype(np.float32)

        # per-vehicle accuracy presence + cleaning in whole-wave passes
        finite = np.isfinite(acc_m)
        if finite.any():
            has_acc = np.bitwise_or.reduceat(finite, mb[:-1])
            acc_clean = np.nan_to_num(acc_m, nan=0.0)
        else:
            has_acc = np.zeros(len(uuids), bool)
            acc_clean = acc_m      # unread: every vehicle gets None

        merged: list[tuple] = []
        traces = []
        for v, u in enumerate(uuids):
            lo, hi = int(mb[v]), int(mb[v + 1])
            merged.append((lat_m[lo:hi], lon_m[lo:hi], t_m[lo:hi],
                           acc_m[lo:hi]))
            traces.append(Trace(
                uuid=u, xy=xy[lo:hi], times=t_m[lo:hi],
                accuracy=(acc_clean[lo:hi] if has_acc[v] else None)))
        wave.merged = merged
        return traces

    def _prepare_wave(self, ripe_codes: np.ndarray,
                      ) -> "tuple[_InflightWave, list] | None":
        """Serial-arm wave prepare: stateful staging +
        trace build inline on the caller's thread. The rows stay in the
        log marked held=wave-id until the result is processed."""
        wave = self._stage_wave(ripe_codes)
        if wave is None:
            return None
        traces = self._build_traces(wave)
        wave.t_submit = self.clock()
        return wave, traces

    def _match_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="wave-match")
        return self._pool

    def _timed_match(self, traces):
        t0 = time.perf_counter()
        result = self.matcher.match_many(traces)
        return result, time.perf_counter() - t0

    def _submit_wave(self, ripe_codes: np.ndarray) -> bool:
        """Pipelined flush, submit half: hand the wave's device match to
        the one-thread executor and return immediately — the link wait
        happens there with the GIL released while the main loop keeps
        consuming."""
        prep = self._prepare_wave(ripe_codes)
        if prep is None:
            return False
        wave, traces = prep
        wave.future = self._match_pool().submit(self._timed_match, traces)
        self._inflight.append(wave)
        return True

    # ---- pipelined wave prepare ------------------------------------------

    def _ra_worker(self):
        if self._ra is None:
            from reporter_tpu_torch.utils.readahead import ReadAheadWorker
            self._ra = ReadAheadWorker(name="wave-prepare")
        return self._ra

    def _stage_readahead(self, ripe_codes: np.ndarray) -> bool:
        """Pipelined-prepare submit half: run the STATEFUL staging here
        (wave order preserved), hand the pure trace build + matcher
        prepare to the read-ahead thread, and queue the wave for
        promotion once a device slot frees."""
        wave = self._stage_wave(ripe_codes)
        if wave is None:
            return False
        # The prepared seam needs the REAL matcher (prepare_many +
        # match_many(prepared=...)). A duck-typed or monkeypatched
        # stand-in (the test harnesses' gate matchers) gets the plain
        # match_many call — the read-ahead thread still overlaps the
        # trace build, just not the pack.
        use_prepared = (getattr(self.matcher, "supports_prepared", False)
                        and "match_many" not in getattr(
                            self.matcher, "__dict__", {}))
        wave.prep = self._ra_worker().submit(
            lambda: self._build_prepared(wave, use_prepared))
        self._staged.append(wave)
        return True

    def _build_prepared(self, wave: "_InflightWave", use_prepared: bool):
        """Read-ahead thread body: the PURE prepare for one staged wave
        (trace build + plan/pack through the matcher's prepared seam).
        Touches no pipeline state — only the wave and endpoint-sampled
        overlap counters (single-writer ints; the gauge is an
        estimate)."""
        overlapped = bool(self._inflight)
        t0 = self.clock()
        traces = self._build_traces(wave)
        prepared = (self.matcher.prepare_many(traces)
                    if use_prepared else None)
        if self._tracer.enabled:
            # the overlapped prepare attributes to its OWN span; the
            # wave's `prepare` stage component still covers
            # t_prep0→t_submit so the telescoping stays arithmetic
            self._tracer.add("prepare_readahead", t0, self.clock(),
                             wave=wave.id, traces=len(traces),
                             packed=prepared is not None)
        self._overlap_total += 1
        if overlapped or self._inflight:
            self._overlap_hits += 1
        return traces, prepared

    def _promote_staged(self, drain: bool = False) -> None:
        """Move staged waves onto the device executor as slots free
        (FIFO — wave order is the parity contract). ``drain`` ignores
        the depth bound: shutdown must flush every staged wave."""
        while self._staged and (drain
                                or len(self._inflight) < self._depth):
            wave = self._staged.pop(0)
            wave.future = self._match_pool().submit(
                self._timed_match_staged, wave)
            self._inflight.append(wave)

    def _timed_match_staged(self, wave: "_InflightWave"):
        """Match-pool thread body for a read-ahead wave: wait for the
        prepare ticket, stamp t_submit (so the `prepare` stage component
        absorbs read-ahead queueing + slot wait and the components still
        telescope), then dispatch — with the prebuilt pack when the
        prepared seam produced one."""
        traces, prepared = wave.prep.result()
        wave.prep = None
        wave.t_submit = self.clock()
        t0 = time.perf_counter()
        if prepared is not None:
            result = self.matcher.match_many(traces, prepared=prepared)
        else:
            result = self.matcher.match_many(traces)
        return result, time.perf_counter() - t0

    def _harvest(self, block: bool) -> int:
        """Process completed waves in submission order (FIFO: wave N+1
        must not retain cache tails before wave N). The non-blocking form
        stops at the first still-running future."""
        n = 0
        while self._inflight and (block or self._inflight[0].future.done()):
            wave = self._inflight.pop(0)
            try:
                result, match_dt = wave.future.result()
                wave.t_result = self.clock()
                # the pop freed a device slot: promote a staged wave
                # BEFORE building this one's reports, so wave N+1
                # occupies the device while wave N's report build runs
                # (the three-stage overlap; prepare for N+2 rides the
                # read-ahead thread). Stateful order is safe: in-flight
                # waves are code-disjoint (_without_busy), so N+1's
                # merge_wave touched no vehicle N's retain_wave will.
                # Promote only on the success path — a failed wave's
                # rows must go back in play before anything advances.
                self._promote_staged()
                n += self._complete_wave(wave, result, match_dt)
            except DispatchTimeout:
                # graceful degradation, not death: the watchdog bounded a
                # wedged device dispatch (matcher dispatch_timeout_s).
                # Release the wave's held rows — the next step
                # re-selects and re-flushes them (the held-row contract;
                # bit-identical on a recovered link) — count it, and keep
                # the loop alive.
                self._release_failed(wave)
                self.dispatch_timeouts += 1
                self.matcher.metrics.gauge("stream_dispatch_timeouts",
                                           self.dispatch_timeouts)
            except BaseException:
                # matcher OR result-processing failure: either way the
                # rows must go back in play, not leak held forever (a
                # leaked hold pins the commit floor and broker retention
                # without bound). Retry may duplicate a partially
                # published wave — at-least-once, never lost.
                self._release_failed(wave)
                raise
        return n

    def _release_failed(self, wave: _InflightWave) -> None:
        """A failed wave's rows go back in play: held rows freed,
        per-code counts restored — the next step re-selects them and the
        supervisor's retry re-flushes (at-least-once; the commit floor
        never moved past them).

        Timeless rows consumed WHILE the wave was in flight were stamped
        index seconds from the submit-time-zeroed count (correct for the
        success path — the dict worker restarts at 0 after a successful
        flush). On failure the dict worker's buffer would have kept
        counting up instead, so re-base those stamps past the restored
        rows — otherwise the retry lexsort interleaves two runs of
        duplicate timestamps into one trace."""
        L = self._log
        rows = np.nonzero(L.held[:L.n] == wave.id)[0]
        held_counts = np.bincount(L.code[rows],
                                  minlength=len(self._count)).astype(np.int64)
        flight = np.nonzero((L.held[:L.n] == 0) & L.tless[:L.n]
                            & (held_counts[L.code[:L.n]] > 0))[0]
        L.time[flight] += held_counts[L.code[flight]].astype(np.float64)
        L.held[rows] = 0
        self._count += held_counts

    def _flush(self, ripe_codes: np.ndarray) -> int:
        """Sequential flush (pipeline_depth=0): match, report, publish in
        line — one wave, fully processed before returning. A watchdog
        timeout degrades exactly like the pipelined path's (_harvest):
        rows released for the next step's retry, counted, loop alive —
        NOT a raise that would kill the sequential worker loop."""
        prep = self._prepare_wave(ripe_codes)
        if prep is None:
            return 0
        wave, traces = prep
        try:
            result, match_dt = self._timed_match(traces)
            wave.t_result = self.clock()
            return self._complete_wave(wave, result, match_dt)
        except DispatchTimeout:
            self._release_failed(wave)
            self.dispatch_timeouts += 1
            self.matcher.metrics.gauge("stream_dispatch_timeouts",
                                       self.dispatch_timeouts)
            return 0
        except BaseException:
            self._release_failed(wave)   # same leak-proofing as _harvest
            raise

    def _complete_wave(self, wave: _InflightWave, result,
                       match_dt: float) -> int:
        """Result-processing half (always the pipeline's thread): build
        and publish reports, update histograms, retain cache tails,
        sample latency, drop the wave's rows from the log."""
        self.stats_counters["match_seconds"] += match_dt
        self.stats_counters["batches"] += 1
        self.stats_counters["traces"] += len(wave.uuids)
        self.stats_counters["points"] += wave.n_points

        if isinstance(result, MatchBatch):
            n = self._reports_from_columns(result, wave)
        else:   # a batch match_many does not interleave (one trace, or a
            #     trace past the largest bucket): per-trace records
            n = self._reports_from_records(result, wave)

        # flushed rows leave the buffer; retained tails live in the cache
        L = self._log
        t_done = self.clock()
        lat = t_done - wave.arrive
        if self._tracer.enabled:
            self._record_wave_stages(wave, t_done, lat)
        # ACCUMULATE between reads: drain() completes many waves in one
        # call, and overwriting would silently discard every wave's
        # samples but the last — biasing p50/p99 low exactly for the
        # highest-latency backlog waves. Readers take-and-reset to None.
        # Bounded newest-N because the CLI worker has NO reader: an
        # uncapped accumulator grows one f64 per probe forever and pays
        # an O(history) concatenate per flush.
        prev = self.last_flush_latency
        acc = lat if prev is None else np.concatenate([prev, lat])
        if len(acc) > self._LAT_SAMPLES_CAP:
            acc = acc[-self._LAT_SAMPLES_CAP:]
        self.last_flush_latency = acc
        self._last_flush_p50 = (float(np.median(lat)) if len(lat) else None)
        L.compact(L.held[:L.n] != wave.id)
        self.waves_completed += 1
        return n

    def _record_wave_stages(self, wave: _InflightWave, t_done: float,
                            lat: np.ndarray) -> None:
        """Tracing-enabled wave bookkeeping: emit the wave's stage spans
        into the flight recorder and accumulate the per-probe stage
        components. The components partition each probe's timeline at
        the wave's recorded boundaries, so per probe they sum EXACTLY to
        its last_flush_latency sample: the reconciliation is
        arithmetic, not coincidence."""
        tr = self._tracer
        n = len(wave.arrive)
        if n and wave.t_prep0 is not None:
            tr.add("broker_dwell", float(wave.arrive.min()), wave.t_prep0,
                   wave=wave.id, points=wave.n_points)
            tr.add("prepare", wave.t_prep0, wave.t_submit, wave=wave.id)
            tr.add("device_match", wave.t_submit, wave.t_result,
                   wave=wave.id, traces=len(wave.uuids))
            tr.add("report_build", wave.t_result, t_done, wave=wave.id)
            comp = {
                "broker_dwell": wave.t_prep0 - wave.arrive,
                "prepare": np.full(n, wave.t_submit - wave.t_prep0),
                "device_match": np.full(n, wave.t_result - wave.t_submit),
                "report_build": np.full(n, t_done - wave.t_result),
                "e2e": lat,
            }
            self._stage_chunks.append(comp)
            self._stage_count += n
            # newest-N bound at whole-wave granularity (take trims to
            # the exact cap): a reader-less traced worker stays flat-RSS
            while (len(self._stage_chunks) > 1
                   and self._stage_count - len(self._stage_chunks[0]["e2e"])
                   >= self._LAT_SAMPLES_CAP):
                dropped = self._stage_chunks.pop(0)
                self._stage_count -= len(dropped["e2e"])

    def take_stage_samples(self) -> "dict[str, np.ndarray] | None":
        """Take-and-reset the accumulated per-probe stage components
        (None when tracing was off or nothing flushed). The arrays are
        parallel: row i of every stage belongs to the same probe, and
        the non-'e2e' stages sum to 'e2e' row-wise. 'publish' rides
        separately (per-wave POST attempt seconds — it completes after
        the probe→report cut on the async publisher)."""
        chunks, self._stage_chunks = self._stage_chunks, []
        self._stage_count = 0
        out = None
        if chunks:
            out = {k: np.concatenate([c[k] for c in chunks])
                   for k in chunks[0]}
            if len(out["e2e"]) > self._LAT_SAMPLES_CAP:
                out = {k: v[-self._LAT_SAMPLES_CAP:]
                       for k, v in out.items()}
        if out is not None and self._publish_durs:
            # swap FIRST, convert after: copy-then-reset would drop any
            # duration the async publisher thread appends between the
            # two statements
            durs, self._publish_durs = self._publish_durs, []
            out = dict(out, publish=np.asarray(durs))
        return out

    def _reports_from_columns(self, batch: MatchBatch,
                              wave: _InflightWave) -> int:
        from reporter_tpu_torch.matcher import native_prepare

        uuids = wave.uuids
        cols = batch.columns
        # group-id chaining in one native pass (build_report_columns is
        # its plain form; the tests hold the two equal)
        rep = native_prepare.build_reports(cols, None,
                                           self.min_segment_length)
        seg, nxt, rt0, rt1, rlen, rqueue, _ = rep
        self.stats_counters["reports"] += len(seg)

        # per-trace latest complete time → tail retention cut
        done = np.full(len(uuids), -np.inf)
        keep = (cols.start_time >= 0.0) & (cols.end_time >= 0.0) \
            & ~cols.internal
        if keep.any():
            np.maximum.at(done, cols.trace[keep], cols.end_time[keep])
        self._retain_tails(wave, done)

        dur = rt1 - rt0
        okd = dur > 0
        pos = np.searchsorted(self._row_sorted, seg[okd])
        pos = np.minimum(pos, len(self._row_sorted) - 1)
        hrows = np.where(self._row_sorted[pos] == seg[okd],
                         self._row_order[pos], -1).astype(np.int32)
        self.hist.update(hrows, rlen[okd] / dur[okd])
        self.qhist.update(hrows, rqueue[okd])

        self._publish_wave(wave, "publish_columns",
                           (seg, nxt, rt0, rt1, rlen, rqueue))
        return int(len(seg))

    def _retain_tails(self, wave: _InflightWave, done: np.ndarray) -> None:
        """Cache-tail retention for a completed wave: every vehicle's
        cut computed in ONE pass over the wave's flat time column
        (native_prepare.tail_cuts, or its per-vehicle reference), then
        the stores with a single deferred TTL/capacity sweep — the same
        final cache state as per-vehicle retain(), without a numpy
        nonzero/max chain and an eviction scan per vehicle."""
        from reporter_tpu_torch.matcher import native_prepare

        lat_m, lon_m, t_m, acc_m, mb = wave.merged_flat
        # from_time: the latest complete report end, else the vehicle's
        # first timestamp (the straddling-pair rule keeps one row before
        # that point either way)
        first_t = (t_m[mb[:-1]] if len(t_m)
                   else np.zeros(len(wave.uuids)))
        from_time = np.where(np.isfinite(done), done, first_t)
        los = native_prepare.tail_cuts(t_m, mb, from_time,
                                       self.cache.max_points)
        self.cache.retain_wave(wave.uuids, lat_m, lon_m, t_m, acc_m, mb,
                               los)

    def _publish_wave(self, wave: _InflightWave, method: str,
                      args: tuple) -> None:
        """Publish a wave's reports, releasing its commit-floor hold when
        the POST ATTEMPT completes. With the async publisher (pipelined)
        the on_done callback fires from the publisher thread after the
        socket wait; the sync publisher calls it before returning — one
        code path, two latencies."""
        self._pending.append(wave)
        traced = self._tracer.enabled
        t_pub0 = self.clock() if traced else 0.0

        def _done(ok: bool, w=wave) -> None:
            w.published = True      # plain attribute flip: GIL-atomic
            if traced:
                t1 = self.clock()
                self._tracer.add("publish", t_pub0, t1, wave=w.id, ok=ok)
                if len(self._publish_durs) < 65536:   # reader-less bound
                    self._publish_durs.append(t1 - t_pub0)

        getattr(self.publisher, method)(*args, on_done=_done)

    def _reports_from_records(self, per_trace, wave: _InflightWave) -> int:
        """The same over per-trace SegmentRecord lists (match_many's list
        result)."""
        from reporter_tpu_torch.service.reports import (Report, build_reports,
                                                  latest_complete_time)

        uuids, merged = wave.uuids, wave.merged
        n = 0
        all_reports: list[Report] = []
        for (u, m, records) in zip(uuids, merged, per_trace):
            reports = build_reports(records, self.min_segment_length)
            all_reports.extend(reports)
            done = latest_complete_time(records)
            from_time = float(m[2][0]) if done is None else done
            self.cache.retain(u, m[0], m[1], m[2], m[3], from_time)
            n += len(reports)
        self.stats_counters["reports"] += n
        rows, speeds, queues = [], [], []
        for r in all_reports:
            dur = r.end_time - r.start_time
            if dur <= 0:
                continue
            pos = int(np.searchsorted(self._row_sorted, r.segment_id))
            pos = min(pos, len(self._row_sorted) - 1)
            row = (int(self._row_order[pos])
                   if self._row_sorted[pos] == r.segment_id else -1)
            rows.append(row)
            speeds.append(r.length / dur)
            queues.append(r.queue_length)
        self.hist.update(np.asarray(rows, np.int32),
                         np.asarray(speeds, np.float64))
        self.qhist.update(np.asarray(rows, np.int32),
                          np.asarray(queues, np.float64))
        self._publish_wave(wave, "publish", (all_reports,))
        return n

    def _commit(self) -> None:
        from reporter_tpu_torch.streaming.state import commit_floor

        holds: "list[tuple[int, int]]" = []
        L = self._log
        if L.n:
            for p in self.partitions:
                m = L.part[:L.n] == p
                if m.any():
                    holds.append((p, int(L.off[:L.n][m].min())))
        # waves hold the floor until their publish attempt completes
        # (in-flight waves' rows are still in the log — the scan above
        # already covers them; the explicit holds make it airtight)
        self._pending = [w for w in self._pending if not w.published]
        for w in self._inflight + self._staged + self._pending:
            holds.extend(w.holds)
        self.committed = commit_floor(self._consumed, holds)

    # ---- histograms (same delta-flush contract as StreamPipeline) -------

    def flush_histograms(self) -> int:
        from reporter_tpu_torch.streaming.state import flush_histogram_delta
        return flush_histogram_delta(self)

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict[str, Any]:
        out = {
            "steps": self.steps,
            "malformed": self.malformed,
            "lag": sum(self.queue.end_offset(p) - self.committed[p]
                       for p in self.partitions),
            "buffered_uuids": int((self._count > 0).sum()),
            "buffered_points": int(self._count.sum()),
            "published": self.publisher.published,
            "publish_dropped": self.publisher.dropped,
            "hist_rows": int(len(self.hist.nonzero_rows())),
            "qhist_rows": int(len(self.qhist.nonzero_rows())),
            # pipelined-flush observability (mirrored as metrics gauges)
            "inflight_waves": len(self._inflight),
            "staged_waves": len(self._staged),
            "pipeline_prepare": bool(self._pp),
            "prepare_overlap_pct": (
                100.0 * self._overlap_hits / self._overlap_total
                if self._overlap_total else 0.0),
            "publish_pending": sum(1 for w in self._pending
                                   if not w.published),
            "wave_points": int(self._wave_points),
            "overrun": int(self.overrun),
            "dispatch_timeouts": int(self.dispatch_timeouts),
            "publish_retried": self.publisher.retried,
            "dead_lettered": self.publisher.dead_lettered,
            "dead_letter_pending": self.publisher.dead_letter_pending,
            # online quality telemetry: every completed wave
            # rode the matcher's per-metro quality window via
            # match_many, so the worker's stats face carries the same
            # windowed rates + drift state the service /health reports
            "quality": self.matcher.quality.snapshot(),
            **self.stats_counters,
        }
        overload = getattr(self.queue, "overload_stats", None)
        if overload is not None:
            out.update(overload())
        return out

    # ---- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Stop the background machinery (call drain() first for a
        graceful shutdown; close alone joins whatever is in flight)."""
        # order matters: the match pool first (promoted waves' tickets
        # need the read-ahead worker ALIVE to resolve), then the
        # read-ahead worker (never-promoted tickets fail loudly — a
        # stale ticket wait must error, not hang)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._ra is not None:
            self._ra.close()
            self._ra = None
        self.publisher.close()

    # ---- checkpoint / resume (StreamPipeline-compatible npz) -------------

    def checkpoint(self, path: str) -> None:
        """Snapshot offsets + uuid cache + histograms at a CONSISTENT
        cut: in-flight waves are harvested and the publisher drained
        first (bounded by the transport timeout), so the snapshot is a
        wave boundary — bitwise-compatible with the dict worker's, as
        the cross-restore suite asserts. A crash that skips this (no
        checkpoint at all) restores from the previous cut, whose
        ``committed`` was clamped below every then-unpublished wave (see
        _commit) — replay covers the wave, at-least-once, never lost."""
        from reporter_tpu_torch.streaming.state import save_checkpoint
        self._promote_staged(drain=True)
        self._harvest(block=True)
        self.publisher.drain()
        self._commit()
        save_checkpoint(path, self.committed, self.cache.dump(),
                        self.hist.snapshot(), self._hist_flushed,
                        self.qhist.snapshot(), self._qhist_flushed)

    def restore(self, path: str) -> None:
        from reporter_tpu_torch.streaming.state import load_checkpoint
        state = load_checkpoint(path, self)
        self.committed = list(state["committed"])
        self._consumed = list(state["committed"])
        self._log = _Log()
        self._count[:] = 0
        self._inflight = []
        self._staged = []
        self._pending = []
        self._prev_lag = 0
        self._last_flush_p50 = None
        outage = max(0.0, time.time()
                     - float(state.get("saved_at", time.time())))
        self.cache.load(state["cache"], extra_age=outage)
