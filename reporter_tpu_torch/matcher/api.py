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
   sweep kernel, or the grid backend's cell-row gather, → Viterbi → wire
   pack), each dispatched as soon as its slice is prepared;
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
raises if any arm fails to run; each candidate's measurement runs under
the dispatch watchdog, bounded by ``autotune.CAL_TIMEOUT_S``, and a hung
one leaves the static default serving, with source "timeout"). The
calibration times the candidate stage alone (``batch_candidates`` on the
decoded ``calibration_batch``, ``CAL_DISPATCHES`` launches between two
CUDA events, one synchronize), not the whole wire entry as the JAX
package does: the port's Viterbi is plain torch, launch-bound and some
200 times the sweep's device time, so whole-entry times would drown the
arms' sub-millisecond differences in host jitter. Only the sweep differs
between plans, so the decision is the same one.

The surface the report service reads is the JAX package's: ``config``
(a Config; a bare MatcherParams still works), ``metrics`` (the "match"
stage timer and the "traces", "probes" and "unmatched_points" counts per
``match_many``), ``quality`` (the per-batch quality signals and drift
sentinel; a sampled batch goes to the shadow audit, quality/audit.py),
``backend`` ("torch", with ``device`` beside it, or "reference_cpu"),
``supports_prepared``, ``matched_points`` and ``DispatchTimeout``.
``match_many`` may run on several threads at once (the service's batch
scheduler does): the shared counters (``stage_seconds``,
``point_counts``, the registry, ``ops.dense_candidates.SWEEP_LAUNCHES``)
update under a lock each.

``Config(matcher_backend="reference_cpu")`` makes the matcher the
exact-Dijkstra oracle (matcher/cpu_reference.py): host work only, no
tables staged, no device, each trace matched alone and walked by the
Python walk with Dijkstra routing.

The dispatch watchdog (``MatcherParams.dispatch_timeout_s`` > 0) runs
each device batch on a daemon thread (utils/watchdog.py) and bounds the
wait; the ``dispatch`` fault site fires inside that body. The body
launches on the thread's default CUDA stream, as the scheduler's threads
do. A timeout is noted in the link-health record
(utils/linkhealth.py). A timed-out batch raises ``DispatchTimeout`` (the
callers' retry: the streaming wave release, the app's 503) or, under
``dispatch_fallback="reference_cpu"``, is served by the oracle, counted
in ``dispatch_fallback``. An exception of the body, a CUDA build or
launch error among them, is re-raised, never degraded. Past four
abandoned bodies still stuck, the breaker degrades at once.

``candidate_backend="grid"`` stages the grid's ``cell_pack`` instead of
the segment pack and gathers candidates from each point's cell row
(ops/candidates.py); the tuner does not act on it (it has no kernel arms,
as in the JAX package), and no sweep instance launches. ``"auto"`` is
dense on both devices (the JAX package takes the grid on a CPU backend).
``match_topk`` ranks a trace's path interpretations (terminal
completions, or with ``exact=True`` the list Viterbi's exact K best) on
the matcher's own candidates.

Fleet paging (fleet/residency.py): ``staged_tables=`` hands the
matcher a staged dict already placed on its device (``place_tables`` of
``TileSet.host_tables``, checked by ``check_staged_layout``; its host
``tuned_plan`` vector resolves the sweep plan without a measurement);
``unstage_tables`` drops the device tables and ``restage_tables`` takes
a freshly placed dict. The matcher keeps its walker, route tables and
tuned plan through any number of cycles and never re-tunes. Every device
entry (``match``, ``match_many``, ``submit_prepared``, ``match_topk``,
``matched_points``, the calibration) reads the tables once per call,
through ``_staged``, which raises ``TablesUnstaged`` while they are
paged out, so a restage between the stages of one batch cannot mix two
placements.

Mesh sharding (parallel/): ``SegmentMatcher(ts, mesh=mesh)`` makes this
matcher, and every front end built on it, the multi-device product
path: each wire entry's rows are split over the mesh's devices, one
``ops.match.wire_from_*`` call per shard on its own device
(parallel/dp_e2e.DpWireMatcher), and the harvest reads the shards back
in row order and drops the padded rows; the host pipeline around it is
unchanged, so the records equal the single-device matcher's. As in the
JAX package, a mesh matcher is not tuned (its params select the arm),
takes no ``staged_tables`` and pages no tables; ``wire_mesh`` is the
mesh, ``device`` its first device (where ``match_topk`` runs).
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Sequence as _SequenceABC
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from reporter_tpu_torch import faults
from reporter_tpu_torch.config import Config, MatcherParams
from reporter_tpu_torch.device import resolve_device
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.matcher import (autotune, cpu_reference,
                                        native_prepare)
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
from reporter_tpu_torch.quality import audit as quality_audit
from reporter_tpu_torch.quality import signals as quality_signals
from reporter_tpu_torch.quality.monitor import QualityMonitor
from reporter_tpu_torch.tiles.tileset import (TileSet, check_staged_layout,
                                              device_members, place_tables)
from reporter_tpu_torch.utils import linkhealth, locks, tracing
from reporter_tpu_torch.utils.metrics import MetricsRegistry
from reporter_tpu_torch.utils.watchdog import (TIMED_OUT,
                                               AbandonedThreadWatchdog)

# padded point-length buckets: one set of device shapes per bucket
_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
# the keys of SegmentMatcher.stage_seconds
STAGES = ("prepare", "dispatch", "device", "walk", "wall")
_QUANTUM = match_ops.OFFSET_QUANTUM


class DispatchTimeout(RuntimeError):
    """A device dispatch exceeded ``matcher.dispatch_timeout_s``. Callers
    treat it as retryable: the streaming pipeline releases the wave's
    held rows for a later flush, the scheduler retries per submission,
    and the WSGI face answers 503."""


class TablesUnstaged(RuntimeError):
    """A device entry of a matcher whose tables are paged out (the fleet's
    cold tier): restage them first, through ``restage_tables`` or the
    fleet's lease."""


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


@dataclass
class MatchedPoint:
    """Per-point match output (diagnostics / tests)."""

    edge: int
    offset: float
    chain_start: bool


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


def _dijkstra_route_fn(ts: TileSet, bound: float,
                       cache: cpu_reference.DijkstraCache) -> RouteFn:
    """The oracle's segment-build routing: intermediate edges from the
    shared Dijkstra memo (None where ``e2`` is out of reach)."""
    def route(e1: int, e2: int):
        if e1 == e2:
            return []
        reached = cache.reached(ts, e1, bound)
        if e2 not in reached:
            return None
        return cpu_reference.walk_prev(reached, e2)

    return route


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
    (``cuda`` unless the caller passes ``device="cpu"``). ``config`` is a
    Config or a bare MatcherParams; ``metrics`` a MetricsRegistry to
    write (a fresh one by default).

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

    # prepare_many is safe on a read-ahead thread (the scheduler probes
    # this before preparing ahead)
    supports_prepared = True

    def __init__(self, tileset: TileSet,
                 config: "Config | MatcherParams | None" = None,
                 metrics: "MetricsRegistry | None" = None,
                 device: "str | torch.device | None" = None,
                 staged_tables: "dict | None" = None, mesh=None):
        self.ts = tileset
        cfg = (config if isinstance(config, Config)
               else Config(matcher=config or MatcherParams())).validate()
        # the RTPU_SWEEP_* overrides apply here, mirrored into config
        self.params = cfg.matcher.with_env_overrides()
        if self.params is not cfg.matcher:
            cfg = dataclasses.replace(cfg, matcher=self.params)
        self.config = cfg
        self.backend = cfg.matcher_backend
        self.metrics = metrics or MetricsRegistry()
        self.quality = QualityMonitor(tileset.name, self.metrics)
        # concurrent match_many calls add to these under one lock
        self._count_lock = locks.named_lock("matcher.counters")
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.point_counts = {"points": 0, "unmatched": 0}
        self.tuned_plan: "autotune.TunedPlan | None" = None
        self.tuned_report: dict = {}
        # the dispatch watchdog's degradation target, built on the first
        # timeout that asks for it. Two locks on purpose: _fallback_lock
        # serializes the oracle (its DijkstraCache is not thread-safe) for
        # a whole slow match, the watchdog's own lock only its ledger
        self._fallback: "SegmentMatcher | None" = None
        self._fallback_lock = locks.named_lock("matcher.fallback")
        self._watchdog = AbandonedThreadWatchdog(
            cap=4, thread_name="dispatch-watchdog")
        self._wire = None           # a mesh's DpWireMatcher
        if mesh is not None:
            if self.backend != "torch":
                raise ValueError(
                    "mesh sharding requires matcher_backend='torch'")
            if staged_tables is not None:
                raise ValueError(
                    "staged_tables injection is single-device only; the "
                    "mesh path places its own tables")
            if device is not None:
                raise ValueError("pass mesh= or device=, not both: the "
                                 "mesh names the devices")
        if self.backend == "reference_cpu":
            if staged_tables is not None:
                raise ValueError(
                    "staged_tables requires matcher_backend='torch'")
            # the oracle is host work: no device, no tables. One Dijkstra
            # memo serves the Viterbi pass and the segment routing, whose
            # bound covers every transition the pass can accept
            self.device = torch.device("cpu")
            self.tables = None
            self._native_walker = None
            self._dij_cache = cpu_reference.DijkstraCache()
            self._route_fn = _dijkstra_route_fn(
                tileset, cpu_reference.viterbi_bound(
                    self.params.breakage_distance, self.params),
                self._dij_cache)
            return
        self.wire_spec = match_ops.wire_spec(
            tileset.num_edges,
            float(tileset.edge_len.max()) if tileset.num_edges else 0.0)
        if mesh is not None:
            from reporter_tpu_torch.parallel.dp_e2e import DpWireMatcher

            self._wire = DpWireMatcher(mesh, tileset, self.params,
                                       self.wire_spec)
            self.device = mesh.flat_devices[0]
            self.tables = self._wire.tables[self.device]
        else:
            self.device = resolve_device(device)
            if staged_tables is None:
                staged_tables = place_tables(
                    tileset.host_tables(self.params.candidate_backend),
                    self.device)
            else:
                # a dict pinned before a layout change fails here, not
                # as a kernel's garbage
                check_staged_layout(staged_tables)
            self.tables: "dict[str, torch.Tensor] | None" = device_members(
                staged_tables)
        self._route_fn = reach_route_fn(tileset)
        self._native_walker = NativeWalker(tileset)
        if mesh is None:
            # as in the JAX package, only a single-device matcher tunes
            self._autotune_resolve(staged_tables)

    @property
    def wire_mesh(self):
        """The mesh this matcher's wire dispatches shard over, or None:
        the seam for layers that must co-shard with the matcher (the
        backfill engine's aggregate partials)."""
        return None if self._wire is None else self._wire.mesh

    # ---- per-metro sweep plan ---------------------------------------------

    def _autotune_resolve(self, staged: dict) -> None:
        """Resolve this metro's sweep plan and apply it to ``params``;
        ``staged`` is the staged dict whose host plan vector the tuner
        reads first and writes back."""
        state: dict = {}

        def measure(plan: "autotune.TunedPlan") -> float:
            if not state:
                state["tables"] = self._staged()
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
                                           state["tables"], p, self.ts.meta)

            # the events record on the matcher's card, whatever the
            # measuring thread's current device
            with torch.cuda.device(self.device):
                run()                   # untimed: builds the kernel library
                torch.cuda.synchronize(self.device)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(autotune.CAL_DISPATCHES):
                    run()
                t1.record()
                t1.synchronize()
            return t0.elapsed_time(t1) / 1e3 / autotune.CAL_DISPATCHES

        # each candidate under the dispatch watchdog: a hung measurement
        # degrades to the static default (source "timeout") instead of
        # hanging construction; the bound is read at call time
        plan, info = autotune.resolve_plan(self.params, self.ts, measure,
                                           watchdog=self._watchdog,
                                           timeout_s=autotune.CAL_TIMEOUT_S,
                                           backend=self.device.type,
                                           device=self.device,
                                           tables=staged)
        if info.get("errors"):
            # calibrate skips an arm that raised; serving another arm
            # would hide a kernel that does not build or launch
            raise RuntimeError(f"sweep calibration: arms failed on "
                               f"{info['device']}: {info['errors']}")
        self.tuned_report = info
        if plan is None or plan.source in ("default", "timeout"):
            return          # the params already are the static default
        self.params = self.params.replace(**plan.params_overrides())
        self.tuned_plan = plan

    @property
    def table_bytes(self) -> int:
        """Bytes of the tables staged on the device: 0 while they are
        paged out, and on the reference_cpu backend."""
        tables = self.tables
        if tables is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in tables.values()))

    # ---- fleet paging -----------------------------------------------------

    @property
    def tables_staged(self) -> bool:
        """False while the device tables are paged out (the fleet's cold
        tier); always False on the reference_cpu backend."""
        return self.tables is not None

    def _paging(self) -> None:
        if self.backend != "torch":
            raise ValueError("table paging requires matcher_backend='torch'")
        if self._wire is not None:
            raise ValueError("table paging is single-device only; a mesh "
                             "matcher keeps its replicated tables")

    def _staged(self) -> "dict[str, torch.Tensor]":
        """The device tables, read once by each device entry."""
        tables = self.tables
        if tables is None:
            raise TablesUnstaged(
                f"metro {self.ts.name!r}: device tables are unstaged (paged "
                "out); restage them before dispatching")
        return tables

    def unstage_tables(self) -> None:
        """Drop the device tables (the fleet's demotion). Their memory
        returns to the caching allocator once nothing refers to them;
        kernels already queued on the stream read them first, by stream
        order. The walker, route tables and tuned plan stay."""
        self._paging()
        self.tables = None

    def restage_tables(self, tables: dict) -> None:
        """Serve from ``tables``, a staged dict placed on this matcher's
        device (the fleet's promotion: the same host values placed
        again, so records are unchanged by any number of cycles). Checked
        by ``check_staged_layout``; a refused dict leaves the matcher
        unstaged. Does not re-tune."""
        self._paging()
        check_staged_layout(tables)
        self.tables = device_members(tables)

    def _add_stage(self, key: str, seconds: float) -> None:
        with self._count_lock:
            self.stage_seconds[key] += seconds

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
        return {"mode": self.config.service.mode,
                "segments": [r.to_json() for r in records]}

    def match_trace(self, trace: Trace) -> list[SegmentRecord]:
        return self.match_many([trace])[0]

    # ---- batched API ------------------------------------------------------

    def match_many(self, traces: Sequence[Trace],
                   prepared: "PreparedBatch | None" = None,
                   ) -> "Sequence[list[SegmentRecord]]":
        """Per-trace record lists, in input order: a MatchBatch when the
        harvest interleaves (more than one trace, each within the largest
        bucket), else a list. ``prepared`` is prepare_many's result for
        these traces. Counts the traces and probes of the call (and the
        unmatched points of a device harvest), times it as the "match"
        stage, records its quality signals and offers a device harvest
        to the shadow audit."""
        t0 = time.perf_counter()
        hold = None
        try:
            with self.metrics.stage("match"), \
                    tracing.tracer().span("match_many", traces=len(traces)):
                if self.backend == "reference_cpu":
                    out = [self._match_cpu(t) for t in traces]
                else:
                    out, hold = self._guarded_many(traces, prepared,
                                                   self._staged())
        finally:
            self._add_stage("wall", time.perf_counter() - t0)
        probes = sum(len(t.xy) for t in traces)
        # a degraded or oracle batch has no device harvest: its unmatched
        # count is unknown (an abandoned body's count is never taken)
        unmatched = None if hold is None else hold["unmatched"]
        with self._count_lock:
            self.point_counts["points"] += probes
            self.point_counts["unmatched"] += unmatched or 0
        self.metrics.count("traces", len(traces))
        self.metrics.count("probes", probes)
        if unmatched is not None:
            self.metrics.count("unmatched_points", unmatched)
        if self.quality.enabled and len(traces):
            nonempty = np.fromiter((len(t.xy) > 0 for t in traces), bool,
                                   len(traces))
            self.quality.record(quality_signals.extract(
                out, len(traces), probes, nonempty,
                max_speed=self.quality.max_speed_mps, unmatched=unmatched))
            if hold is not None:
                # only real device harvests: auditing the oracle (or a
                # batch the oracle served) against itself is vacuous
                quality_audit.maybe_audit(self, traces, out)
        return out

    def _guarded_many(self, traces: Sequence[Trace],
                      prepared: "PreparedBatch | None", tables: dict):
        """The device batch on ``tables``, under the watchdog when
        dispatch_timeout_s > 0. → (records, hold): hold["unmatched"] is
        the harvest's unmatched points, hold None where the batch
        degraded."""
        hold = {"unmatched": 0}
        timeout = float(self.params.dispatch_timeout_s)
        if timeout <= 0:
            faults.fire("dispatch")
            return self._match_many(traces, prepared, hold, tables), hold
        if self._watchdog.tripped:
            # the breaker is open: enough abandoned dispatches are still
            # stuck, so degrade at once instead of pinning another thread
            # and batch; counted as a timeout too, so dispatch_timeout
            # keeps moving while the breaker stays open
            self.metrics.count("dispatch_breaker_open")
            self.metrics.count("dispatch_timeout")
            tracing.post_mortem("breaker_open", failing="device_dispatch",
                                traces=len(traces),
                                abandoned=self._watchdog.abandoned)
            return self._degrade(traces, timeout), None
        # recorded before the guarded body: a dispatch that never returns
        # still shows in the post-mortem as the last thing started
        tracing.tracer().instant("device_dispatch", traces=len(traces))
        out = self._watchdog.run(
            lambda: self._match_many(traces, prepared, hold, tables), timeout,
            fault_site="dispatch")
        if out is not TIMED_OUT:
            return out, hold
        self.metrics.count("dispatch_timeout")
        tracing.post_mortem("dispatch_timeout", failing="device_dispatch",
                            traces=len(traces), timeout_s=timeout)
        # the dead-link signal into the link-health record: the watchdog
        # saw the stall long before the low-duty probe would; the
        # post-mortem above is this event's one dump
        linkhealth.note_dispatch_timeout("dispatch_timeout")
        return self._degrade(traces, timeout), None

    def _degrade(self, traces: Sequence[Trace], timeout: float):
        """A bounded dispatch's outcome: the oracle's records under
        dispatch_fallback="reference_cpu", else DispatchTimeout."""
        if self.params.dispatch_fallback == "reference_cpu":
            self.metrics.count("dispatch_fallback")
            fb = self._fallback_matcher()
            with self._fallback_lock:   # the DijkstraCache: one user
                return fb.match_many(traces)
        raise DispatchTimeout(
            f"device dispatch exceeded {timeout:.3f}s "
            f"({len(traces)} traces); wave released for retry")

    def _fallback_matcher(self) -> "SegmentMatcher":
        """The exact-Dijkstra oracle over the same tile and params, built
        on first use, with its own registry (the outer call counts the
        batch) and its quality telemetry off (the outer matcher records
        the batch's signals)."""
        with self._fallback_lock:
            if self._fallback is None:
                self._fallback = SegmentMatcher(
                    self.ts, dataclasses.replace(
                        self.config, matcher_backend="reference_cpu"))
                self._fallback.quality.enabled = False
        return self._fallback

    def _match_cpu(self, trace: Trace) -> list[SegmentRecord]:
        """One trace through the oracle, walked with Dijkstra routing."""
        pts = cpu_reference.match_trace_cpu(
            self.ts, trace.xy.astype(np.float64), self.params,
            self._dij_cache, accuracy=trace.accuracy)
        return build_segments(self.ts, _to_chains(pts, trace.times),
                              self._route_fn, self.params.backward_slack)

    def _match_many(self, traces: Sequence[Trace],
                    prepared: "PreparedBatch | None", hold: dict,
                    tables: dict):
        """The device batch on ``tables``; adds its unmatched points to
        ``hold["unmatched"]``."""
        if not self._interleaves(traces):
            decoded = self._decode_many(traces, tables)
            hold["unmatched"] += sum(int((e < 0).sum())
                                     for e, _, _ in decoded)
            t1 = time.perf_counter()
            out = self._walk_decoded(traces, decoded)
            self._add_stage("walk", time.perf_counter() - t1)
            return out
        if prepared is not None:
            work = prepared.work
            inflight = [self._dispatch(ps, tables)
                        for ps in prepared.slices]
        else:
            work, inflight = self._submit_many(traces, tables)
        slice_cols: list = [None] * len(inflight)

        def walk_slice(k, ws, arr):
            slice_cols[k], un = self.walk_wire_columns(traces, work, ws, arr)
            hold["unmatched"] += un     # one worker thread: no race

        self._harvest_overlapped(inflight, walk_slice)
        return MatchBatch(_merge_columns(slice_cols), len(traces))

    def matched_points(self, trace: Trace) -> "list[MatchedPoint]":
        """Per-point decode (no segment association): a diagnostic of the
        device path."""
        if self.backend != "torch":
            raise NotImplementedError(
                "matched_points decodes through the device path; "
                "construct the matcher with matcher_backend='torch'")
        trip = self._decode_many([trace], self._staged())[0]
        return [MatchedPoint(int(e), float(o), bool(st))
                for e, o, st in zip(*trip)]

    def match_topk(self, trace: Trace, exact: bool = False,
                   ) -> "list[tuple[float, list[MatchedPoint]]]":
        """Ranked path interpretations of one trace, best first, as (score,
        per-point MatchedPoint list) pairs (chain_start False). The best
        path is the global optimum. ``exact=False``: each alternate is the
        optimal path ending at one of the final chain's terminal
        candidates (ops/hmm.viterbi_topk_paths); ``exact=True``: the final
        chain's ``max_candidates`` globally best paths (the list Viterbi,
        viterbi_kbest_paths). Candidates come from the matcher's own
        ``batch_candidates`` (the tuned sweep instance, or the grid
        gather) with the accuracy down-weighting ``match`` applies.
        Defined over at most one largest bucket (1024 points): ranked
        alternates do not compose across chunks, so a longer trace raises
        ValueError. The reference_cpu backend raises
        NotImplementedError."""
        if self.backend != "torch":
            raise NotImplementedError(
                "match_topk requires the torch backend")
        if len(trace.xy) > _BUCKETS[-1]:
            raise ValueError(
                f"match_topk is defined over ≤{_BUCKETS[-1]} points "
                f"(got {len(trace.xy)}); ranked alternates do not compose "
                "across chunks — split or decimate the trace, or use "
                "match_many for the best-path decode")
        from reporter_tpu_torch.ops.hmm import (viterbi_kbest_paths,
                                                viterbi_topk_paths)

        tables = self._staged()
        xy = trace.xy
        n = len(xy)
        pts = np.zeros((1, _bucket_len(max(n, 1)), 2), np.float32)
        pts[0, :n] = xy
        valid = np.zeros((1, pts.shape[1]), bool)
        valid[0, :n] = True
        pj = torch.from_numpy(pts).to(self.device)
        vj = torch.from_numpy(valid).to(self.device)
        cands = match_ops.batch_candidates(pj, vj, tables, self.params,
                                           self.ts.meta)
        tc = match_ops.CandidateSet(*(x[0] for x in cands))
        p = self.params
        if trace.accuracy is not None:
            scale = _accuracy_scale(trace.accuracy[:n], p.sigma_z,
                                    pts.shape[1])
            tc = tc._replace(dist=tc.dist * torch.from_numpy(scale).to(
                self.device)[:, None])
        args = (tc, pj[0], vj[0], tables, p.sigma_z, p.beta,
                p.max_route_distance_factor, p.breakage_distance,
                p.backward_slack, p.interpolation_distance)
        if exact:
            choices, scores, ok = viterbi_kbest_paths(
                *args, num_paths=p.max_candidates)
        else:
            choices, scores, ok = viterbi_topk_paths(*args)
        ce, co = tc.edge.cpu().numpy(), tc.offset.cpu().numpy()
        choices, scores, ok = (x.cpu().numpy() for x in (choices, scores, ok))
        out = []
        for r in range(choices.shape[0]):
            if not ok[r]:
                continue
            out.append((float(scores[r]), [
                MatchedPoint(int(ce[t, c]) if c >= 0 else -1,
                             float(co[t, c]) if c >= 0 else 0.0, False)
                for t, c in enumerate(choices[r][:n])]))
        return out

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
        take it (the oracle, or a batch that does not interleave)."""
        if self.backend != "torch" or not self._interleaves(traces):
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

    def submit_prepared(self, ps: PreparedSlice,
                        tables: "dict | None" = None) -> torch.Tensor:
        """Dispatch one prepared slice on ``tables`` (the batch's capture;
        None reads the matcher's own); returns the wire tensor (on CUDA
        the call returns once the work is queued), or on a mesh a
        ShardedWire, whose ``cpu()`` is the harvest too."""
        if tables is None:
            tables = self._staged()
        wire = self._wire
        if wire is not None:            # the mesh: its own tables per shard
            if ps.mode == 2:
                return wire.q8(ps.payload, ps.origins, ps.lens, ps.scale)
            if ps.mode == 1:
                return wire.q16(ps.payload, ps.origins, ps.lens, ps.scale)
            return wire.f32(ps.pts, ps.lens, ps.scale)

        def dev(x):
            return None if x is None else torch.from_numpy(x).to(self.device)

        lens, origins, acc = dev(ps.lens), dev(ps.origins), dev(ps.scale)
        meta = self.ts.meta
        if ps.mode == 2:
            return match_ops.wire_from_q8(dev(ps.payload), origins, lens,
                                          tables, self.params, acc,
                                          self.wire_spec, meta)
        if ps.mode == 1:
            return match_ops.wire_from_q16(dev(ps.payload), origins, lens,
                                           tables, self.params, acc,
                                           self.wire_spec, meta)
        return match_ops.wire_from_f32(dev(ps.pts), lens, tables,
                                       self.params, acc, self.wire_spec, meta)

    def _submit_many(self, traces: Sequence[Trace],
                     tables: "dict | None" = None):
        """Prepare each slice and dispatch it on ``tables`` (None: the
        matcher's own, read once) at once, so the card starts on slice 0
        while later slices are prepared. → (work, inflight): inflight =
        [(slice work indices, wire tensor)] in submission order."""
        if tables is None:
            tables = self._staged()
        t0 = time.perf_counter()
        work, sliced = self.plan_submit(traces)
        self._add_stage("prepare", time.perf_counter() - t0)
        inflight = []
        for b, ws in sliced:
            t0 = time.perf_counter()
            ps = self.prepare_submit_slice(traces, work, b, ws)
            self._add_stage("prepare", time.perf_counter() - t0)
            inflight.append(self._dispatch(ps, tables))
        return work, inflight

    def _dispatch(self, ps: PreparedSlice, tables: dict):
        """submit_prepared, timed as "dispatch". → (ws, wire)."""
        t0 = time.perf_counter()
        wire = self.submit_prepared(ps, tables)
        self._add_stage("dispatch", time.perf_counter() - t0)
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
            self._add_stage("walk", time.perf_counter() - t0)

        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = []
            for k, (ws, wire) in enumerate(inflight):
                t0 = time.perf_counter()
                arr = wire.cpu().numpy()
                self._add_stage("device", time.perf_counter() - t0)
                futs.append(pool.submit(timed, k, ws, arr))
            for f in futs:
                f.result()

    def walk_wire_columns(self, traces: Sequence[Trace], work,
                          ws: "list[int]", arr: np.ndarray,
                          ) -> "tuple[RecordColumns, int]":
        """Unpack + C column walk of one harvested slice's wire → (record
        columns with global trace indices (rows Morton-ordered; sorted by
        _merge_columns), the slice's unmatched real points)."""
        edges, offs, starts = match_ops.unpack_wire(arr[:len(ws)],
                                                    self.wire_spec)
        B, T = edges.shape
        times = np.zeros((B, T), np.float64)
        pad = 0
        for r, w in enumerate(ws):
            i, lo, xy = work[w]
            times[r, :len(xy)] = traces[i].times[lo:lo + len(xy)]
            pad += T - len(xy)          # the padded tail decodes unmatched
        cols = self._native_walker.walk_columns(
            edges, offs, starts, times, self.params.backward_slack)
        row_to_trace = np.asarray([work[w][0] for w in ws], np.int32)
        return (cols._replace(trace=row_to_trace[cols.trace]),
                int((edges < 0).sum()) - pad)

    def _decode_many(self, traces: Sequence[Trace],
                     tables: "dict | None" = None):
        """Per-trace (edges, offsets, chain_starts) numpy triples (a trace
        past the largest bucket reassembled from its chunks), decoded on
        ``tables`` (None: the matcher's own)."""
        work, inflight = self._submit_many(traces, tables)
        per_trace: list[list[tuple[int, Any]]] = [[] for _ in traces]

        def split_slice(_k, ws, arr):
            edges, offs, starts = match_ops.unpack_wire(arr[:len(ws)],
                                                        self.wire_spec)
            for r, w in enumerate(ws):
                i, lo, xy = work[w]
                T = len(xy)
                per_trace[i].append(
                    (lo, (edges[r, :T], offs[r, :T], starts[r, :T])))

        # one request or long traces: no second slice to overlap, so the
        # harvest is a plain loop
        for k, (ws, wire) in enumerate(inflight):
            t0 = time.perf_counter()
            arr = wire.cpu().numpy()
            self._add_stage("device", time.perf_counter() - t0)
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
