"""SegmentMatcher — the matcher's public API, on the PyTorch device path.

Counterpart: reporter_tpu/matcher/api.py (the single-device jax backend
with the native prepare and walk). ``match(trace_json) → {"mode",
"segments"}`` for one request; ``match_many(traces)`` is the throughput
path:

1. host prepare: traces are padded into length buckets, Morton-sorted by
   their first point within each bucket (neighbouring traces share point
   chunks of the sweep), and quantized — i8 per-step deltas of 0.25 m
   quanta where every step fits, else i16 quanta, else f32 points — by
   the C prepare (matcher/native_prepare.py);
2. device: one ``ops.match.wire_from_*`` call per bucket slice (dense
   sweep kernel → Viterbi → wire pack), each dispatched as soon as its
   slice is prepared;
3. host harvest: ``unpack_wire`` and the C edge walk
   (matcher/native_walk.py) turn the wire into record columns. A worker
   thread walks slice k while the main thread waits on slice k + 1's
   ``.cpu()`` (``_harvest_overlapped``); the result is a ``MatchBatch``,
   per-trace records built on access. A batch of one trace, or with a
   trace past the largest bucket, is decoded first and then walked.

The Python walk (matcher/segments.build_segments, ``walk_python``) serves
no path: it is the plain version the tests and ``chip_smoke.py`` hold the
C walk against. The native library is built with g++ at first use
(native/build.py); a failed build raises.

Construction applies the RTPU_SWEEP_* overrides to the params and, on the
card, resolves the sweep's kernel arm for this metro (matcher/autotune.py:
explicit levers, then the on-disk cache, then a calibration, which
raises if any arm fails to run). The
calibration times the candidate stage alone (``batch_candidates`` on the
decoded ``calibration_batch``, ``CAL_DISPATCHES`` launches between two
CUDA events, one synchronize), not the whole wire entry as the JAX
package does: the port's Viterbi is plain torch, launch-bound and some
200 times the sweep's device time, so whole-entry times would drown the
arms' sub-millisecond differences in host jitter. Only the sweep differs
between plans, so the decision is the same one.

Not ported here: the watchdog and fallback oracle, quality telemetry,
fleet paging (and with it a plan staged in the tables) and mesh sharding.
"""

from __future__ import annotations

import time
from collections.abc import Sequence as _SequenceABC
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.device import resolve_device
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.matcher import autotune, native_prepare
from reporter_tpu_torch.matcher.native_walk import (NativeWalker,
                                                    RecordColumns,
                                                    empty_columns,
                                                    materialize_records,
                                                    record_bounds)
from reporter_tpu_torch.matcher.segments import (MatchedChain, RouteFn,
                                                 SegmentRecord,
                                                 build_segments,
                                                 reach_route_fn)
from reporter_tpu_torch.ops import match as match_ops
from reporter_tpu_torch.tiles.tileset import TileSet, tables_from_numpy

# padded point-length buckets: one set of device shapes per bucket
_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
# the keys of SegmentMatcher.stage_seconds
STAGES = ("prepare", "dispatch", "device", "walk", "wall")
_QUANTUM = match_ops.OFFSET_QUANTUM


@dataclass
class Trace:
    """Normalized input trace (host-side)."""

    uuid: str
    xy: np.ndarray       # [T, 2] float32 tile-local meters
    times: np.ndarray    # [T] float64 seconds
    accuracy: "np.ndarray | None" = None  # [T] f32 reported GPS accuracy
    #                                       (m); None ⇒ sigma_z everywhere

    @classmethod
    def from_json(cls, payload: dict, ts: TileSet) -> "Trace":
        pts = payload.get("trace", [])
        lonlat = np.array([[p["lon"], p["lat"]] for p in pts], np.float64)
        times = np.array([p.get("time", i) for i, p in enumerate(pts)], np.float64)
        if len(lonlat) == 0:
            lonlat = np.zeros((0, 2))
        xy = lonlat_to_xy(lonlat, np.asarray(ts.meta.origin_lonlat))
        acc = None
        if any("accuracy" in p for p in pts):
            acc = np.array([float(p.get("accuracy", 0.0)) for p in pts],
                           np.float32)
        return cls(uuid=str(payload.get("uuid", "")), xy=xy.astype(np.float32),
                   times=times, accuracy=acc)


class PreparedSlice(NamedTuple):
    """One bucket slice after the host prepare, before dispatch."""

    b: int                       # point bucket (padded length)
    ws: "list[int]"              # work indices (Morton order)
    mode: int                    # 2 = i8 delta, 1 = i16 quantized, 0 = f32
    pts: np.ndarray              # f32 [B, b, 2] points (the mode-0 payload)
    lens: np.ndarray             # i32 [B]
    origins: np.ndarray          # f32 [B, 2]
    payload: Any                 # i8 / i16 [B, b, 2], or None in mode 0
    scale: "np.ndarray | None"   # f32 [B, b] accuracy → emission scale


class PreparedBatch(NamedTuple):
    """A whole match_many call's host prepare, done ahead of dispatch
    (``prepare_many``): the same plan_submit / prepare_submit_slice calls
    in the same order, only moved in time."""

    work: Any                        # plan_submit's work list
    slices: "list[PreparedSlice]"    # in submission order


class MatchBatch(_SequenceABC):
    """Columnar ``match_many`` result: a sequence of per-trace
    ``list[SegmentRecord]`` whose records live as flat numpy columns
    (``.columns``, sorted by trace index, drive order within a trace);
    a trace's SegmentRecord objects are built when it is indexed."""

    def __init__(self, columns: RecordColumns, n_traces: int):
        if not isinstance(columns, RecordColumns):
            raise TypeError("MatchBatch takes RecordColumns")
        if columns.n_records and np.any(np.diff(columns.trace) < 0):
            # per-trace slicing is searchsorted-based: unsorted columns
            # would misattribute records
            raise ValueError("MatchBatch requires trace-sorted columns")
        self.columns = columns
        self._n = n_traces
        self._bounds = record_bounds(columns, n_traces)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return materialize_records(self.columns, int(self._bounds[i]),
                                   int(self._bounds[i + 1]))

    @property
    def n_records(self) -> int:
        return self.columns.n_records


def _accuracy_scale(accuracy: "np.ndarray | None", sigma_z: float,
                    n: int) -> np.ndarray:
    """[n] f32 emission distance scale: sigma_z / max(sigma_z, accuracy),
    1.0 where accuracy is absent."""
    scale = np.ones(n, np.float32)
    if accuracy is None:
        return scale
    a = np.asarray(accuracy[:n], np.float32)
    sz = np.float32(sigma_z)
    scale[:len(a)] = sz / np.maximum(sz, a)
    return scale


class SegmentMatcher:
    """Map matcher over one TileSet, its tables staged on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``).

    ``stage_seconds`` accumulates, per ``match_many``: "prepare", the host
    prepare (plan and slices); "dispatch", the main thread's time queueing
    the wire entries; "device", the main thread's wait in the wires'
    ``.cpu()``; "walk", the summed time inside the walk calls (unpack and C
    walk, on the harvest's worker thread where it overlaps the next wait);
    and "wall", the batch's wall time. Under overlap the stages add up to
    more than "wall". ``point_counts`` holds the real points decoded and
    those left unmatched. ``tuned_plan`` is the sweep plan the tuner
    applied (None where it did not act) and ``tuned_report`` what it did
    and measured."""

    def __init__(self, tileset: TileSet, params: MatcherParams | None = None,
                 device: "str | torch.device | None" = None):
        self.ts = tileset
        self.params = (params or MatcherParams()).with_env_overrides()
        self.device = resolve_device(device)
        self.tables = tables_from_numpy(tileset.arrays(), self.device)
        self.wire_spec = match_ops.wire_spec(
            tileset.num_edges,
            float(tileset.edge_len.max()) if tileset.num_edges else 0.0)
        self._route_fn = reach_route_fn(tileset)
        self._native_walker = NativeWalker(tileset)
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.point_counts = {"points": 0, "unmatched": 0}
        self.tuned_plan: "autotune.TunedPlan | None" = None
        self.tuned_report: dict = {}
        self._autotune_resolve()

    # ---- per-metro sweep plan ---------------------------------------------

    def _autotune_resolve(self) -> None:
        """Resolve this metro's sweep plan and apply it to ``params``."""
        state: dict = {}

        def measure(plan: "autotune.TunedPlan") -> float:
            if not state:
                pts_q, origins, lens = autotune.calibration_batch(self.ts)
                q = torch.from_numpy(pts_q).to(self.device)
                o = torch.from_numpy(origins).to(self.device)
                quantum = torch.tensor(_QUANTUM, dtype=torch.float32,
                                       device=self.device)
                state["pts"] = o[:, None, :] + q.to(torch.float32) * quantum
                state["valid"] = match_ops._valid(
                    torch.from_numpy(lens).to(self.device), q.shape[1])
            p = self.params.replace(**plan.params_overrides())

            def run():
                match_ops.batch_candidates(state["pts"], state["valid"],
                                           self.tables, p)

            run()                       # untimed: builds the kernel library
            torch.cuda.synchronize(self.device)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(autotune.CAL_DISPATCHES):
                run()
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) / 1e3 / autotune.CAL_DISPATCHES

        plan, info = autotune.resolve_plan(self.params, self.ts, measure,
                                           backend=self.device.type)
        if info.get("errors"):
            # calibrate skips an arm that raised; serving another arm
            # would hide a kernel that does not build or launch
            raise RuntimeError(f"sweep calibration: arms failed on "
                               f"{info['device']}: {info['errors']}")
        self.tuned_report = info
        if plan is None or plan.source == "default":
            return          # the params already are the static default
        self.params = self.params.replace(**plan.params_overrides())
        self.tuned_plan = plan

    def tuned_plan_array(self) -> "np.ndarray | None":
        """The applied plan as the i32[5] plan vector, or None untuned."""
        if self.tuned_plan is None:
            return None
        return autotune.plan_array(self.tuned_plan)

    # ---- single-trace API -------------------------------------------------

    def match(self, trace_json: dict) -> dict:
        """Request in (uuid + trace of {lat, lon, time}), segments out."""
        trace = Trace.from_json(trace_json, self.ts)
        records = self.match_trace(trace)
        return {"mode": "auto", "segments": [r.to_json() for r in records]}

    def match_trace(self, trace: Trace) -> list[SegmentRecord]:
        return self.match_many([trace])[0]

    # ---- batched API ------------------------------------------------------

    def match_many(self, traces: Sequence[Trace],
                   prepared: "PreparedBatch | None" = None,
                   ) -> "Sequence[list[SegmentRecord]]":
        """Per-trace record lists, in input order: a MatchBatch when the
        harvest interleaves (more than one trace, each within the largest
        bucket), else a list. ``prepared`` is prepare_many's result for
        these traces."""
        t0 = time.perf_counter()
        try:
            if not self._interleaves(traces):
                decoded = self._decode_many(traces)
                t1 = time.perf_counter()
                out = self._walk_decoded(traces, decoded)
                self.stage_seconds["walk"] += time.perf_counter() - t1
                return out
            if prepared is not None:
                work = prepared.work
                inflight = [self._dispatch(ps) for ps in prepared.slices]
            else:
                work, inflight = self._submit_many(traces)
            slice_cols: list = [None] * len(inflight)

            def walk_slice(k, ws, arr):
                slice_cols[k] = self.walk_wire_columns(traces, work, ws, arr)

            self._harvest_overlapped(inflight, walk_slice)
            return MatchBatch(_merge_columns(slice_cols), len(traces))
        finally:
            self.stage_seconds["wall"] += time.perf_counter() - t0

    @staticmethod
    def _interleaves(traces: Sequence[Trace]) -> bool:
        """The overlapped columnar harvest serves this batch: more than
        one trace, none split into chunks past the largest bucket."""
        return len(traces) > 1 and all(len(t.xy) <= _BUCKETS[-1]
                                       for t in traces)

    def prepare_many(self, traces: Sequence[Trace],
                     ) -> "PreparedBatch | None":
        """The host prepare of a whole batch ahead of dispatch (safe on a
        read-ahead thread: no device work, no shared state written, so its
        time is not in ``stage_seconds``). None where match_many would not
        take it (the batch does not interleave)."""
        if not self._interleaves(traces):
            return None
        work, sliced = self.plan_submit(traces)
        return PreparedBatch(work, [self.prepare_submit_slice(traces, work,
                                                              b, ws)
                                    for b, ws in sliced])

    def plan_submit(self, traces: Sequence[Trace]):
        """Work list + Morton-sorted bucket slices: work[w] = (trace index,
        chunk offset, xy); sliced = [(bucket, [work indices])]. Traces past
        the largest bucket are decoded in consecutive independent chunks."""
        max_b = _BUCKETS[-1]
        work: list[tuple[int, int, np.ndarray]] = []
        for i, t in enumerate(traces):
            if len(t.xy) <= max_b:
                work.append((i, 0, t.xy))
            else:
                for lo in range(0, len(t.xy), max_b):
                    work.append((i, lo, t.xy[lo:lo + max_b]))
        by_bucket: dict[int, list[int]] = {}
        for w, (_, _, xy) in enumerate(work):
            by_bucket.setdefault(_bucket_len(len(xy)), []).append(w)
        keys = _morton_keys(work)
        for ws in by_bucket.values():
            arr = np.asarray(ws)
            ws[:] = arr[np.argsort(keys[arr], kind="stable")].tolist()
        chunk = max(1, self.params.max_device_batch)
        sliced = [(b, ws[i:i + chunk])
                  for b, ws in sorted(by_bucket.items())
                  for i in range(0, len(ws), chunk)]
        return work, sliced

    def prepare_submit_slice(self, traces: Sequence[Trace], work, b: int,
                             ws: "list[int]") -> PreparedSlice:
        """Host prepare of one slice (the C prepare): quantized payload +
        accuracy scale. No device work."""
        mode, pts, lens, origins, payload = native_prepare.prepare_slice(
            [work[w][2] for w in ws], b)
        scale = None
        if any(traces[work[w][0]].accuracy is not None for w in ws):
            scale = np.ones((len(ws), b), np.float32)
            for r, w in enumerate(ws):
                i, lo, xy = work[w]
                a = traces[i].accuracy
                if a is not None:
                    scale[r] = _accuracy_scale(
                        a[lo:lo + len(xy)], self.params.sigma_z, b)
        return PreparedSlice(b, list(ws), mode, pts, lens, origins,
                             payload, scale)

    def submit_prepared(self, ps: PreparedSlice) -> torch.Tensor:
        """Dispatch one prepared slice; returns the wire tensor (on CUDA
        the call returns once the work is queued)."""
        def dev(x):
            return None if x is None else torch.from_numpy(x).to(self.device)

        lens, origins, acc = dev(ps.lens), dev(ps.origins), dev(ps.scale)
        if ps.mode == 2:
            return match_ops.wire_from_q8(dev(ps.payload), origins, lens,
                                          self.tables, self.params, acc,
                                          self.wire_spec)
        if ps.mode == 1:
            return match_ops.wire_from_q16(dev(ps.payload), origins, lens,
                                           self.tables, self.params, acc,
                                           self.wire_spec)
        return match_ops.wire_from_f32(dev(ps.pts), lens, self.tables,
                                       self.params, acc, self.wire_spec)

    def _submit_many(self, traces: Sequence[Trace]):
        """Prepare each slice and dispatch it at once, so the card starts
        on slice 0 while later slices are prepared. → (work, inflight):
        inflight = [(slice work indices, wire tensor)] in submission
        order."""
        t0 = time.perf_counter()
        work, sliced = self.plan_submit(traces)
        self.stage_seconds["prepare"] += time.perf_counter() - t0
        inflight = []
        for b, ws in sliced:
            t0 = time.perf_counter()
            ps = self.prepare_submit_slice(traces, work, b, ws)
            self.stage_seconds["prepare"] += time.perf_counter() - t0
            inflight.append(self._dispatch(ps))
        return work, inflight

    def _dispatch(self, ps: PreparedSlice):
        """submit_prepared, timed as "dispatch". → (ws, wire)."""
        t0 = time.perf_counter()
        wire = self.submit_prepared(ps)
        self.stage_seconds["dispatch"] += time.perf_counter() - t0
        return ps.ws, wire

    def _harvest_overlapped(self, inflight, per_slice) -> None:
        """Harvest the wires in submission order with one worker thread:
        the main thread's ``.cpu()`` of slice k + 1 waits on the card (the
        GIL released) while the worker runs ``per_slice(k, ws, host
        array)`` on slice k, whose time counts as "walk" and the wait as
        "device". The worker's exceptions propagate."""
        def timed(k, ws, arr):
            t0 = time.perf_counter()
            per_slice(k, ws, arr)
            self.stage_seconds["walk"] += time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = []
            for k, (ws, wire) in enumerate(inflight):
                t0 = time.perf_counter()
                arr = wire.cpu().numpy()
                self.stage_seconds["device"] += time.perf_counter() - t0
                futs.append(pool.submit(timed, k, ws, arr))
            for f in futs:
                f.result()

    def walk_wire_columns(self, traces: Sequence[Trace], work,
                          ws: "list[int]", arr: np.ndarray) -> RecordColumns:
        """Unpack + C column walk of one harvested slice's wire → record
        columns with global trace indices (rows Morton-ordered; sorted by
        _merge_columns)."""
        edges, offs, starts = match_ops.unpack_wire(arr[:len(ws)],
                                                    self.wire_spec)
        B, T = edges.shape
        times = np.zeros((B, T), np.float64)
        pad = 0
        for r, w in enumerate(ws):
            i, lo, xy = work[w]
            times[r, :len(xy)] = traces[i].times[lo:lo + len(xy)]
            pad += T - len(xy)          # the padded tail decodes unmatched
        self.point_counts["points"] += B * T - pad
        self.point_counts["unmatched"] += int((edges < 0).sum()) - pad
        cols = self._native_walker.walk_columns(
            edges, offs, starts, times, self.params.backward_slack)
        row_to_trace = np.asarray([work[w][0] for w in ws], np.int32)
        return cols._replace(trace=row_to_trace[cols.trace])

    def _decode_many(self, traces: Sequence[Trace]):
        """Per-trace (edges, offsets, chain_starts) numpy triples (a trace
        past the largest bucket reassembled from its chunks)."""
        work, inflight = self._submit_many(traces)
        per_trace: list[list[tuple[int, Any]]] = [[] for _ in traces]

        def split_slice(_k, ws, arr):
            edges, offs, starts = match_ops.unpack_wire(arr[:len(ws)],
                                                        self.wire_spec)
            for r, w in enumerate(ws):
                i, lo, xy = work[w]
                T = len(xy)
                per_trace[i].append(
                    (lo, (edges[r, :T], offs[r, :T], starts[r, :T])))
                self.point_counts["points"] += T
                self.point_counts["unmatched"] += int((edges[r, :T] < 0).sum())

        # one request or long traces: no second slice to overlap, so the
        # harvest is a plain loop
        for k, (ws, wire) in enumerate(inflight):
            t0 = time.perf_counter()
            arr = wire.cpu().numpy()
            self.stage_seconds["device"] += time.perf_counter() - t0
            split_slice(k, ws, arr)
        out: list[Any] = []
        for chunks in per_trace:
            chunks.sort(key=lambda c: c[0])
            if len(chunks) == 1:
                out.append(chunks[0][1])
            else:
                out.append(tuple(np.concatenate(parts)
                                 for parts in zip(*(c[1] for c in chunks))))
        return out

    def _walk_decoded(self, traces: Sequence[Trace],
                      decoded) -> list[list[SegmentRecord]]:
        """NativeWalker.walk of decoded per-trace triples, padded to one
        [B, T] array."""
        B = len(traces)
        tmax = max((len(e) for e, _, _ in decoded), default=1) or 1
        edges = np.full((B, tmax), -1, np.int32)
        offs = np.zeros((B, tmax), np.float32)
        starts = np.zeros((B, tmax), np.uint8)
        times = np.zeros((B, tmax), np.float64)
        for b, (trace, (e, o, st)) in enumerate(zip(traces, decoded)):
            t = len(e)
            edges[b, :t] = e
            offs[b, :t] = o
            starts[b, :t] = st
            times[b, :t] = trace.times[:t]
        return self._native_walker.walk(edges, offs, starts, times,
                                        self.params.backward_slack)



def walk_python(ts: TileSet, traces: Sequence[Trace], decoded,
                route_fn: RouteFn, backward_slack: float,
                ) -> list[list[SegmentRecord]]:
    """The Python walk (matcher/segments.build_segments) of decoded
    per-trace triples: the plain version of the C walk."""
    out = []
    for trace, (edges, offs, starts) in zip(traces, decoded):
        pts = [(int(e), float(o), bool(st))
               for e, o, st in zip(edges, offs, starts)]
        out.append(build_segments(ts, _to_chains(pts, trace.times),
                                  route_fn, backward_slack))
    return out


def _merge_columns(slices: list) -> RecordColumns:
    """Concatenate per-slice RecordColumns (trace already global) and
    stable-sort the rows by trace, so each trace's records are one
    contiguous range in drive order."""
    slices = [c for c in slices if c is not None and c.n_records]
    if not slices:
        return empty_columns()
    if len(slices) == 1:
        cat = slices[0]
    else:
        way_offs = []
        base = 0
        for c in slices:
            way_offs.append(c.way_off[:-1] + base)
            base += int(c.way_off[-1])
        way_offs.append(np.asarray([base], np.int64))
        cat = RecordColumns(
            *(np.concatenate([getattr(c, f) for c in slices])
              for f in ("trace", "segment_id", "start_time", "end_time",
                        "length", "queue_length", "internal")),
            np.concatenate(way_offs),
            np.concatenate([c.way_ids for c in slices]))
    order = np.argsort(cat.trace, kind="stable")
    if np.array_equal(order, np.arange(len(order))):
        return cat
    lens = cat.way_off[1:] - cat.way_off[:-1]
    new_lens = lens[order]
    new_off = np.concatenate([np.zeros(1, np.int64), np.cumsum(new_lens)])
    # gather each reordered record's way-id run from the old flat array
    idx = (np.repeat(cat.way_off[:-1][order], new_lens)
           + np.arange(int(new_off[-1]), dtype=np.int64)
           - np.repeat(new_off[:-1], new_lens))
    return RecordColumns(
        cat.trace[order], cat.segment_id[order], cat.start_time[order],
        cat.end_time[order], cat.length[order], cat.queue_length[order],
        cat.internal[order], new_off, cat.way_ids[idx])


def _morton_keys(work) -> np.ndarray:
    """Morton keys of every work item's first point (the C form of
    native_prepare.morton_keys_python)."""
    first = np.zeros((len(work), 2), np.float64)
    for w, (_, _, xy) in enumerate(work):
        if len(xy):
            first[w] = xy[0]
    return native_prepare.morton_keys(first)


def _bucket_len(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _to_chains(pts: list[tuple[int, float, bool]], times: np.ndarray,
               ) -> list[MatchedChain]:
    """Group per-point (edge, offset, chain_start) into MatchedChains,
    dropping unmatched points."""
    chains: list[MatchedChain] = []
    cur: MatchedChain | None = None
    for t, (e, off, start) in enumerate(pts):
        if e < 0:
            continue
        if cur is None or start:
            cur = MatchedChain(edges=[], offsets=[], times=[])
            chains.append(cur)
        cur.edges.append(int(e))
        cur.offsets.append(float(off))
        cur.times.append(float(times[t]))
    return chains
