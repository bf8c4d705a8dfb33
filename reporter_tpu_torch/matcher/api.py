"""SegmentMatcher — the matcher's public API, on the PyTorch device path.

Counterpart: reporter_tpu/matcher/api.py (the single-device jax backend
with the Python walk). ``match(trace_json) → {"mode", "segments"}`` for
one request; ``match_many(traces)`` is the throughput path:

1. host prepare: traces are padded into length buckets, Morton-sorted by
   their first point within each bucket (neighbouring traces share point
   chunks of the sweep), and quantized — i8 per-step deltas of 0.25 m
   quanta where every step fits, else i16 quanta, else f32 points;
2. device: one ``ops.match.wire_from_*`` call per bucket slice (dense
   sweep kernel → Viterbi → wire pack);
3. host harvest: ``unpack_wire`` and the Python edge walk
   (matcher/segments.build_segments) turn the wire into SegmentRecords.

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
fleet paging (and with it a plan staged in the tables), mesh sharding
and the native C prepare and walk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.device import resolve_device
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.matcher import autotune
from reporter_tpu_torch.matcher.segments import (MatchedChain, SegmentRecord,
                                                 build_segments,
                                                 reach_route_fn)
from reporter_tpu_torch.ops import match as match_ops
from reporter_tpu_torch.ops.dense_candidates import _morton
from reporter_tpu_torch.tiles.tileset import TileSet, tables_from_numpy

# padded point-length buckets: one set of device shapes per bucket
_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
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


def prepare_slice(xys: Sequence[np.ndarray], b: int):
    """Pad → i16 quantize → i8 delta pack (the JAX package's
    native_prepare.prepare_slice_python). Returns (mode, pts, lens,
    origins, payload): mode 2 ⇒ payload is the i8 delta wire, 1 ⇒ the
    i16 absolute wire (a step overflowed ±127 quanta), 0 ⇒ f32 points (a
    trace spans past the i16 range, or carries NaN/inf) and no payload."""
    B = len(xys)
    pts = np.zeros((B, b, 2), np.float32)
    lens = np.zeros(B, np.int32)
    L = len(xys[0]) if xys else 0
    if L and all(len(xy) == L for xy in xys):
        pts[:, :L] = np.stack(xys)
        pts[:, L:] = pts[:, :1]        # pad at origin: keeps i16 range
        lens[:] = L
    else:
        for r, xy in enumerate(xys):
            pts[r, :len(xy)] = xy
            if len(xy):
                pts[r, len(xy):] = xy[0]
                lens[r] = len(xy)
    origins = pts[:, 0, :].copy()
    dq = np.round((pts - origins[:, None, :]) * np.float32(1.0 / _QUANTUM))
    if np.abs(dq).max(initial=0.0) < 32767:
        dqi = dq.astype(np.int32)
        d8 = np.diff(dqi, axis=1, prepend=dqi[:, :1] * 0)
        d8[np.arange(b)[None, :] >= lens[:, None]] = 0
        if np.abs(d8).max(initial=0) < 128:
            return 2, pts, lens, origins, d8.astype(np.int8)
        return 1, pts, lens, origins, dqi.astype(np.int16)
    return 0, pts, lens, origins, None


def morton_keys(first: np.ndarray) -> np.ndarray:
    """Keys of [W, 2] f64 first points at 64 m resolution, biased positive
    so negative tile-local coordinates keep locality."""
    q = np.floor(first / 64.0).astype(np.int64) + 0x8000
    return _morton((q[:, 0] & 0xFFFF).astype(np.uint32),
                   (q[:, 1] & 0xFFFF).astype(np.uint32))


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

    ``stage_seconds`` accumulates wall time per stage of ``match_many``:
    "prepare" (host), "device" (dispatch through the synchronizing
    harvest of the wire) and "walk" (unpack + edge walk); ``point_counts``
    the real points decoded and those left unmatched. ``tuned_plan`` is
    the sweep plan the tuner applied (None where it did not act) and
    ``tuned_report`` what it did and measured."""

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
        self.stage_seconds = {"prepare": 0.0, "device": 0.0, "walk": 0.0}
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

    def match_many(self, traces: Sequence[Trace]) -> list[list[SegmentRecord]]:
        """Per-trace record lists, in input order."""
        decoded = self._decode_many(traces)
        t0 = time.perf_counter()
        out = []
        for trace, (edges, offs, starts) in zip(traces, decoded):
            pts = [(int(e), float(o), bool(s))
                   for e, o, s in zip(edges, offs, starts)]
            chains = _to_chains(pts, trace.times)
            out.append(build_segments(self.ts, chains, self._route_fn,
                                      self.params.backward_slack))
        self.stage_seconds["walk"] += time.perf_counter() - t0
        return out

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
        first = np.zeros((len(work), 2), np.float64)
        for w, (_, _, xy) in enumerate(work):
            if len(xy):
                first[w] = xy[0]
        keys = morton_keys(first)
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
        """Host prepare of one slice: quantized payload + accuracy scale."""
        mode, pts, lens, origins, payload = prepare_slice(
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

    def _decode_many(self, traces: Sequence[Trace]):
        """Per-trace (edges, offsets, chain_starts) numpy triples."""
        t0 = time.perf_counter()
        work, sliced = self.plan_submit(traces)
        prepared = [self.prepare_submit_slice(traces, work, b, ws)
                    for b, ws in sliced]
        t1 = time.perf_counter()
        wires = [(ps.ws, self.submit_prepared(ps)) for ps in prepared]
        host = [(ws, wire.cpu().numpy()) for ws, wire in wires]
        t2 = time.perf_counter()
        per_trace: list[list[tuple[int, Any]]] = [[] for _ in traces]
        for ws, arr in host:
            edges, offs, starts = match_ops.unpack_wire(arr, self.wire_spec)
            for r, w in enumerate(ws):
                i, lo, xy = work[w]
                T = len(xy)
                per_trace[i].append(
                    (lo, (edges[r, :T], offs[r, :T], starts[r, :T])))
                self.point_counts["points"] += T
                self.point_counts["unmatched"] += int((edges[r, :T] < 0).sum())
        out: list[Any] = []
        for chunks in per_trace:
            chunks.sort(key=lambda c: c[0])
            if len(chunks) == 1:
                out.append(chunks[0][1])
            else:
                out.append(tuple(np.concatenate(parts)
                                 for parts in zip(*(c[1] for c in chunks))))
        self.stage_seconds["prepare"] += t1 - t0
        self.stage_seconds["device"] += t2 - t1
        self.stage_seconds["walk"] += time.perf_counter() - t2
        return out


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
