"""The report service — WSGI app and request pipeline.

Counterpart: reporter_tpu/service/app.py (``ReporterApp``, ``make_app``),
over the port's SegmentMatcher:

  POST /report {"uuid", "trace": [{lat, lon, time}…]}
    ├─ validate; merge with the per-uuid cached partial trace
    ├─ SegmentMatcher.match_many (batched on the card)
    ├─ filter fully-traversed segments; update the uuid cache's tail
    ├─ build reports [{id, next_id, t0, t1, length, queue_length}]
    └─ POST to DATASTORE_URL (when configured)

``POST /report_many {"traces": [<report payload>…]}`` matches a fleet in
one batch. ``GET /health``, ``/stats``, ``/metrics`` (Prometheus text),
``/slo`` (the SLO plane's burn status, obs/slo.py) and
``/aggregates[?segment=<id>]`` (a backfill run's harvested, k-anonymized
document from the ``aggregates`` store, backfill/aggregate.py) are the
JAX app's; ``/health`` carries the link-health block (the process
sampler's latest probe of the host–card path, utils/linkhealth.py) and
``/metrics`` its ``rtpu_link_*`` gauges. A dispatch past the matcher's
watchdog answers 503. The app is a bare WSGI callable, servable by any
WSGI server and by the stdlib runner in service/server.py.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from typing import Any, Callable, Iterable
from urllib.parse import parse_qs

import torch

from reporter_tpu_torch.config import Config
from reporter_tpu_torch.matcher.api import (DispatchTimeout, SegmentMatcher,
                                            Trace)
from reporter_tpu_torch.obs import slo as obs_slo
from reporter_tpu_torch.service.cache import PartialTraceCache
from reporter_tpu_torch.service.datastore import (DatastorePublisher,
                                                  Transport,
                                                  publisher_kwargs)
from reporter_tpu_torch.service.reports import (Report, build_reports,
                                                latest_complete_time)
from reporter_tpu_torch.service.scheduler import (BatchScheduler,
                                                  ServiceOverloaded)
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils import linkhealth, locks, tracing

log = logging.getLogger("reporter_tpu_torch.service")


class BadRequest(ValueError):
    pass


class _Submission:
    """One report_many call's slice of a combined batch."""

    __slots__ = ("pairs", "done", "results", "error")

    def __init__(self, pairs):
        self.pairs = pairs
        self.done = threading.Event()
        self.results: list[dict] = []
        self.error: "Exception | None" = None


def _validate_payload(payload: Any,
                      expected_mode: "str | None" = None,
                      ) -> tuple[str, list[dict]]:
    if not isinstance(payload, dict):
        raise BadRequest("payload must be a JSON object")
    # Mode is a deployment property (one app serves one mode, like the
    # reference's per-mode valhalla config): a request naming a different
    # mode would silently get the wrong costing — reject it instead.
    if (expected_mode is not None and "mode" in payload
            and payload["mode"] != expected_mode):
        raise BadRequest(
            f"this service matches mode {expected_mode!r}; "
            f"request asked for {payload['mode']!r}")
    uuid = payload.get("uuid")
    if not isinstance(uuid, str) or not uuid:
        raise BadRequest("missing or invalid 'uuid'")
    pts = payload.get("trace")
    if not isinstance(pts, list) or not pts:
        raise BadRequest("missing or empty 'trace'")
    for p in pts:
        if not isinstance(p, dict) or "lat" not in p or "lon" not in p:
            raise BadRequest("trace points need 'lat' and 'lon'")
    # Points without explicit time get index seconds (reference tolerates
    # timeless fixtures the same way).
    # json.loads accepts the NaN/Infinity literals, and a single NaN
    # coordinate/scale poisons the whole trace's decode device-side —
    # every numeric field must be a finite number or the request is a 400.
    def finite(p: dict, key: str, default=None) -> float:
        v = p.get(key, default)
        try:
            f = float(v)
        except (TypeError, ValueError):
            raise BadRequest(f"{key!r} must be a number")
        if not math.isfinite(f):
            raise BadRequest(f"{key!r} must be finite")
        return f

    out = []
    for i, p in enumerate(pts):
        norm = {"lat": finite(p, "lat"), "lon": finite(p, "lon"),
                "time": finite(p, "time", i)}
        if "accuracy" in p:   # optional per-point GPS accuracy (m)
            acc = finite(p, "accuracy")
            if acc < 0:
                raise BadRequest("'accuracy' must be >= 0")
            norm["accuracy"] = acc
        out.append(norm)
    out.sort(key=lambda p: p["time"])
    return uuid, out


class ReporterApp:
    """Request pipeline around the port's SegmentMatcher, its tables on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``), or
    across the devices of ``mesh`` (a parallel.mesh.Mesh: dp-sharded
    dispatches, parallel/dp_e2e; the request pipeline, cache and report
    build are unchanged and the results equal a single device's), or
    around an injected ``matcher`` over the same tileset (the fleet's,
    whose tables it pages).

    Concurrency (``service.batching``): the default ``"scheduler"`` runs
    requests through the continuous in-flight batcher
    (service/scheduler.py): deadline batch close, trace-count padding,
    up to ``max_inflight_batches`` batches at once. ``"combine"`` keeps
    the queue-and-combine leader (one batch in flight, lock held through
    the dispatch) for A/B comparison."""

    def __init__(self, tileset: TileSet, config: Config | None = None,
                 transport: Transport | None = None,
                 device: "str | torch.device | None" = None,
                 aggregates=None,
                 matcher: "SegmentMatcher | None" = None, mesh=None):
        self.config = (config or Config()).validate()
        svc = self.config.service
        tracing.configure_from_service(svc)   # span recorder (global)
        if matcher is not None and (matcher.ts is not tileset
                                    or mesh is not None):
            # injection is for the fleet, which pages the tables of its
            # own matchers; another tile's matcher would serve the wrong
            # metro's map
            raise ValueError("injected matcher must wrap the same tileset, "
                             "without a mesh")
        self.matcher = (matcher if matcher is not None else
                        SegmentMatcher(tileset, self.config, device=device,
                                       mesh=mesh))
        # link-health gauges: the process sampler probes the host–card
        # path at low duty and publishes rtpu_link_* into this app's
        # registry (RTPU_LINK_PROBE=0 disables; utils/linkhealth.py)
        linkhealth.ensure_serving(self.matcher.metrics, self.matcher.device)
        self.cache = PartialTraceCache(ttl=svc.cache_ttl,
                                       max_uuids=svc.cache_max_uuids)
        self.publisher = DatastorePublisher(
            transport=transport,
            **publisher_kwargs(svc, metrics=self.matcher.metrics))
        self.min_segment_length = svc.min_segment_length
        # an AggregateStore a backfill run installs its harvested document
        # into; GET /aggregates reads it (None: 404)
        self.aggregates = aggregates
        self._lock = locks.named_lock("app.combine")  # combine mode: one batch in flight
        self._pending: list[_Submission] = []
        self._pending_lock = locks.named_lock("app.pending")
        self._stats_lock = locks.named_lock("app.stats")  # scheduler batches run
        #                                       _process_validated concurrently
        self.stats = {"requests": 0, "traces": 0, "points": 0,
                      "reports": 0, "errors": 0, "match_seconds": 0.0,
                      "batches": 0, "batched_submissions": 0}
        self.scheduler: "BatchScheduler | None" = (
            BatchScheduler(self) if svc.batching == "scheduler" else None)
        # SLO plane: burn-rate evaluation over this app's own registry.
        # Ticks ride the request path (self-throttled) and GET /slo; no
        # ledger here: durable alert ledgers belong to the worker CLI
        # (snapshot spool) and the supervisor (workdir)
        self.slo: "obs_slo.SloEvaluator | None" = (
            obs_slo.SloEvaluator(self.matcher.metrics)
            if obs_slo.enabled() else None)

    # ---- core pipeline ---------------------------------------------------

    def _bump(self, key: str, delta: int = 1) -> None:
        # request/error totals mirror into the registry before the stats
        # lock is taken: the registry's lock stays a leaf
        if key == "requests":
            self.matcher.metrics.count("http_requests", delta)
        elif key == "errors":
            self.matcher.metrics.count("http_errors", delta)
        # scheduler mode makes concurrent WSGI handler threads the norm:
        # every stats mutation goes through the lock or loses increments
        with self._stats_lock:
            self.stats[key] += delta

    def report_one(self, payload: dict) -> dict:
        return self.report_many([payload])[0]

    def report_many(self, payloads: Iterable[dict]) -> list[dict]:
        """Validate → merge cache → batched match → filter/publish/retain.

        Scheduler mode (default): validated requests are admitted to the
        in-flight batcher — batches close by size or SLO deadline, pad
        to trace-count rungs, and up to ``max_inflight_batches`` batches
        run at once (service/scheduler.py).

        Combine mode: requests that arrive while a device batch is in
        flight enqueue themselves; the lock holder drains the queue and
        matches everything as ONE batch — concurrency raises batch size
        instead of queueing device dispatches, but the leader holds the
        lock through the whole batch, so there is never more than one
        batch in flight. Validation errors stay request-scoped
        either way (raised here, before enqueueing).
        """
        pairs = [_validate_payload(p, self.config.service.mode)
                 for p in payloads]
        if self.scheduler is not None:
            return self.scheduler.submit(pairs)
        sub = _Submission(pairs)
        with self._pending_lock:
            self._pending.append(sub)

        while not sub.done.is_set():
            # Try to become the leader first (the uncontended path must not
            # pay any wait); re-attempt after each timeout — the previous
            # leader may have exited between our enqueue and its last drain.
            if self._lock.acquire(blocking=False):
                try:
                    self._drain_pending(until=sub)
                finally:
                    self._lock.release()
            else:
                sub.done.wait(timeout=0.005)
        if sub.error is not None:
            raise sub.error
        return sub.results

    def _drain_pending(self, until: "_Submission | None" = None) -> None:
        """Leader: process everything queued, in arrival order, as one
        combined batch per drain round. Runs under self._lock. Stops after
        the round that completes ``until`` (waiters retake leadership), so
        a leader's own response is never delayed by later arrivals."""
        while True:
            with self._pending_lock:
                batch, self._pending = self._pending, []
            if not batch:
                return
            combined = [pair for s in batch for pair in s.pairs]
            try:
                results = self._process_validated(combined)
                lo = 0
                for s in batch:
                    s.results = results[lo:lo + len(s.pairs)]
                    lo += len(s.pairs)
            except Exception as exc:   # matcher/publisher failure: fail the
                for s in batch:        # co-batched requests, keep serving
                    s.error = exc
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["batched_submissions"] += len(batch)
            for s in batch:
                s.done.set()
            if until is not None and until.done.is_set():
                return

    def _prefab_validated(self,
                          validated: "list[tuple[str, list[dict]]]",
                          ) -> tuple:
        """The dispatch-free head of ``_process_validated``: in-batch
        duplicate merge, cache merge (READ-only — retains are deferred
        to the tail), Trace build, shape padding, and the matcher's
        prepared seam. Safe to run AHEAD of the dispatch on the
        scheduler's read-ahead thread: the batch's uuids are
        disjoint from every in-flight batch (per-uuid deferral), so the
        cache tails it reads are exactly what an inline call would
        read."""
        items = []
        in_batch: dict[str, list[dict]] = {}   # uuid → merged-so-far points
        for uuid, pts in validated:
            prior = in_batch.get(uuid)
            if prior is not None:
                # Duplicate uuid within one batch: later items see earlier
                # items' points, exactly as if they had arrived sequentially.
                seen = {p["time"] for p in prior}
                pts = prior + [p for p in pts if p["time"] not in seen]
                pts.sort(key=lambda p: p["time"])
            merged = self.cache.merge(uuid, pts)
            in_batch[uuid] = merged
            items.append((uuid, merged))

        traces = [
            Trace.from_json({"uuid": u, "trace": pts}, self.matcher.ts)
            for u, pts in items
        ]
        n_real = len(traces)
        if self.scheduler is not None:
            # Trace-count padding: the padded tail rides the dispatch and
            # is dropped below (zip stops at the real items); results for
            # real traces are unchanged (decode is independent of batch
            # composition).
            traces = self.scheduler.pad_traces(traces)
        prepared = None
        if (self.config.service.pipeline_prepare
                and getattr(self.matcher, "supports_prepared", False)
                and "match_many" not in getattr(self.matcher,
                                                "__dict__", {})):
            prepared = self.matcher.prepare_many(traces)
        return items, traces, n_real, prepared

    def _process_validated(self,
                           validated: "list[tuple[str, list[dict]]]",
                           prefab: "tuple | None" = None,
                           ) -> list[dict]:
        if prefab is None:
            prefab = self._prefab_validated(validated)
        items, traces, n_real, prepared = prefab
        t0 = time.perf_counter()
        if prepared is not None:
            per_trace = self.matcher.match_many(traces, prepared=prepared)
        else:
            per_trace = self.matcher.match_many(traces)
        dt = time.perf_counter() - t0
        if len(traces) > n_real:
            # match_many metered the padded list; the /stats north-star
            # counters must credit REAL work only (padding cost is priced
            # separately: sched_batch_occupancy / padding_by_bucket)
            self.matcher.metrics.count("traces", n_real - len(traces))
            self.matcher.metrics.count(
                "probes", -sum(len(t.xy) for t in traces[n_real:]))

        out = []
        all_reports: list[Report] = []
        retains: list[tuple[str, list[dict], float]] = []
        n_traces = n_points = n_reports = 0
        t_build0 = time.perf_counter()
        for (uuid, merged), records in zip(items, per_trace):
            reports = build_reports(records, self.min_segment_length)
            all_reports.extend(reports)
            done = latest_complete_time(records)
            # Cache retains are DEFERRED to the end: any exception out of
            # this method must leave the cache unmutated, so the
            # scheduler's per-submission isolation retry re-merges the
            # same points the failed combined attempt saw (a mid-loop
            # retain would silently drop completed segments from the
            # retried responses). done=None: whole merged trace may
            # still be mid-segment.
            retains.append((uuid, merged,
                            merged[0]["time"] if done is None else done))
            out.append({
                "mode": self.config.service.mode,
                "segments": [r.to_json() for r in records],
                "reports": [r.to_json() for r in reports],
            })
            n_traces += 1
            n_points += len(merged)
            n_reports += len(reports)
        # per-stage series feeding /stats p50s and /metrics histograms: a
        # request's wall time decomposes as queue age (scheduler) + match
        # + build + publish, each its own observed series
        m = self.matcher.metrics
        t_pub0 = time.perf_counter()
        m.observe("report_build_seconds", t_pub0 - t_build0)
        self.publisher.publish(all_reports)
        m.observe("publish_seconds", time.perf_counter() - t_pub0)
        for uuid, merged, from_time in retains:   # arrival order: a later
            self.cache.retain(uuid, merged, from_time)   # duplicate wins
        with self._stats_lock:
            self.stats["traces"] += n_traces
            self.stats["points"] += n_points
            self.stats["reports"] += n_reports
            self.stats["match_seconds"] += dt
        return out

    def health(self) -> dict:
        """The JAX package's /health keys; ``device`` beside ``backend``,
        and ``tile_hbm_bytes`` the bytes of the tables staged on that
        device."""
        with self._stats_lock:
            stats = dict(self.stats)
        out = {
            "status": "ok",
            "backend": self.matcher.backend,
            "device": str(self.matcher.device),
            "tileset": self.matcher.ts.name,
            "edges": self.matcher.ts.num_edges,
            "tile_hbm_bytes": self.matcher.table_bytes,
            "cached_uuids": len(self.cache),
            "published": self.publisher.published,
            "dropped": self.publisher.dropped,
            "publish_retried": self.publisher.retried,
            "dead_lettered": self.publisher.dead_lettered,
            "dead_letter_pending": self.publisher.dead_letter_pending,
            **stats,
        }
        if self.scheduler is not None:
            # operators see saturation (admission depth, in-flight
            # batches, padding/deferral counters) without the metrics port
            out["scheduler"] = self.scheduler.snapshot()
        # match quality: the per-metro window and drift sentinel state
        out["quality"] = self.matcher.quality.health()
        # SLO roll-up: alerting objectives and budget remaining at the
        # liveness face; the full burn detail at /slo
        if self.slo is not None:
            out["slo"] = self.slo.health()
        # link mood: the latest probe and the measured duty, so a
        # degraded or dead path shows at the liveness face before it
        # shows as dispatch timeouts
        s = linkhealth.sampler() if linkhealth.enabled() else None
        last = s.latest() if s is not None else None
        out["link"] = {
            "mood": (None if last is None else last.mood),
            "rtt_ms": (None if last is None or last.rtt_s is None
                       else round(last.rtt_s * 1e3, 2)),
            "mbps": (None if last is None or last.mbps is None
                     else round(last.mbps, 2)),
            "probe_duty_pct": (None if s is None
                               else s.probe_duty_pct()),
        }
        return out

    def close(self) -> None:
        """Graceful drain: flush and stop the scheduler (new requests get
        503), then close the publisher. Idempotent; safe in combine mode
        (no scheduler to drain)."""
        if self.scheduler is not None:
            self.scheduler.close()
        self.publisher.close()

    # ---- WSGI ------------------------------------------------------------

    def __call__(self, environ: dict, start_response: Callable):
        method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")
        if method == "POST":
            t0 = time.perf_counter()
            try:
                return self._dispatch(environ, start_response, method, path)
            finally:
                self.matcher.metrics.observe(
                    "request_seconds", time.perf_counter() - t0)
                if self.slo is not None:
                    # self-throttled burn evaluation rides the request
                    # path, so a serving app alerts without a poller
                    self.slo.tick()
        return self._dispatch(environ, start_response, method, path)

    def _dispatch(self, environ: dict, start_response: Callable,
                  method: str, path: str):
        try:
            if path == "/health" and method == "GET":
                return _respond(start_response, 200, self.health())
            if path == "/stats" and method == "GET":
                # per-stage timings and the counters (probes, traces,
                # p50 match latency, errors)
                return _respond(start_response, 200,
                                self.matcher.metrics.snapshot())
            if path == "/metrics" and method == "GET":
                # Prometheus text exposition (fixed-bucket histograms
                # alongside /stats' reservoir percentiles; /stats is
                # unchanged — operators keep both faces)
                return _respond_text(
                    start_response, 200,
                    self.matcher.metrics.render_prometheus())
            if path == "/slo" and method == "GET":
                # error-budget status: burn rates per window pair, budget
                # remaining, alert states
                if self.slo is None:
                    return _respond(start_response, 200,
                                    {"enabled": False})
                self.slo.tick()
                return _respond(start_response, 200, self.slo.status())
            if path == "/aggregates" and method == "GET":
                # backfill's document, k-anonymized at harvest: read only
                if self.aggregates is None:
                    return _respond(start_response, 404,
                                    {"error": "no aggregates wired"})
                qs = parse_qs(environ.get("QUERY_STRING", ""))
                segment = (qs.get("segment") or [None])[0]
                doc = self.aggregates.snapshot(segment)
                if doc is None:
                    return _respond(
                        start_response, 404,
                        {"error": ("unknown segment" if segment
                                   else "no backfill harvest installed")})
                return _respond(start_response, 200, doc)
            if path == "/report" and method == "POST":
                body = _read_json(environ)
                self._bump("requests")
                return _respond(start_response, 200, self.report_one(body))
            if path == "/report_many" and method == "POST":
                body = _read_json(environ)
                traces = body.get("traces") if isinstance(body, dict) else None
                if not isinstance(traces, list):
                    raise BadRequest("payload must be {'traces': [...]}")
                self._bump("requests")
                results = self.report_many(traces)
                return _respond(start_response, 200, {"results": results})
            if path in ("/report", "/report_many"):
                return _respond(start_response, 405,
                                {"error": f"{method} not allowed"})
            return _respond(start_response, 404, {"error": "not found"})
        except BadRequest as exc:
            self._bump("errors")
            return _respond(start_response, 400, {"error": str(exc)})
        except ServiceOverloaded as exc:
            # bounded admission queue full (or draining): shed explicitly
            # with a retryable status instead of queueing without bound
            self._bump("errors")
            return _respond(start_response, 503, {"error": str(exc)})
        except DispatchTimeout as exc:
            # a dispatch past the watchdog: retryable, not a client error
            self._bump("errors")
            return _respond(start_response, 503, {"error": str(exc)})
        except Exception:                                 # pragma: no cover
            self._bump("errors")
            log.exception("unhandled error serving %s %s", method, path)
            return _respond(start_response, 500, {"error": "internal error"})


def _read_json(environ: dict) -> Any:
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        length = 0
    raw = environ["wsgi.input"].read(length) if length else b""
    if not raw:
        raise BadRequest("empty body")
    try:
        return json.loads(raw)
    except json.JSONDecodeError as exc:
        raise BadRequest(f"invalid JSON: {exc}") from exc


def _respond_text(start_response: Callable, status: int, text: str):
    body = text.encode()
    start_response(f"{status} OK", [
        ("Content-Type", "text/plain; version=0.0.4; charset=utf-8"),
        ("Content-Length", str(len(body))),
    ])
    return [body]


def _respond(start_response: Callable, status: int, payload: dict):
    body = json.dumps(payload).encode()
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 500: "Internal Server Error",
              503: "Service Unavailable"}
    start_response(f"{status} {reason.get(status, '')}".strip(), [
        ("Content-Type", "application/json"),
        ("Content-Length", str(len(body))),
    ])
    return [body]


def make_app(tileset: TileSet, config: Config | None = None,
             transport: Transport | None = None,
             device: "str | torch.device | None" = None,
             aggregates=None, mesh=None) -> ReporterApp:
    """Construct the WSGI app: the matcher's tables staged on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``) or across
    ``mesh``; ``aggregates`` the AggregateStore GET /aggregates
    serves."""
    return ReporterApp(tileset, config, transport, device=device,
                       aggregates=aggregates, mesh=mesh)
