"""Datastore publisher.

Counterpart: reporter_tpu/service/datastore.py (``DatastorePublisher``,
``AsyncDatastorePublisher``, ``publisher_kwargs``, ``publish``,
``publish_columns``, ``publish_json``, retry with bounded exponential
backoff and seeded jitter, the dead-letter spool). Report batches are
POSTed as ``{"mode", "reports": [...]}`` to ``DATASTORE_URL`` on urllib;
the transport is injectable so tests capture payloads without a network.
"""

from __future__ import annotations

import json
import logging
import os
import queue as _queue
import threading
import time
import urllib.error
import urllib.request
from typing import Callable

from reporter_tpu_torch import faults
from reporter_tpu_torch.service.reports import Report
from reporter_tpu_torch.utils import locks, tracing

log = logging.getLogger("reporter_tpu_torch.datastore")

# transport(url, payload_bytes) → HTTP status code
Transport = Callable[[str, bytes], int]


def _report_rows(seg, nxt, t0, t1, length, queue) -> list[dict]:
    """Report columns → wire rows: the columnar row shape, shared by the
    sync and async publishers so the payload format cannot fork. ``nxt``
    uses -1 for "exit to unknown" (serialized as null, like
    Report.to_json)."""
    return [{"id": s, "next_id": (None if x < 0 else x),
             "t0": a, "t1": b, "length": ln, "queue_length": q}
            for s, x, a, b, ln, q in zip(
                seg.tolist(), nxt.tolist(), t0.tolist(), t1.tolist(),
                length.tolist(), queue.tolist())]


def publisher_kwargs(svc, metrics=None) -> dict:
    """ServiceConfig → publisher constructor kwargs: THE mapping, so a
    resilience knob added to the config cannot be wired into one
    publisher and forgotten in another."""
    return dict(url=svc.datastore_url, mode=svc.mode,
                retries=svc.publish_retries,
                backoff_ms=svc.publish_backoff_ms,
                backoff_cap_ms=svc.publish_backoff_cap_ms,
                backoff_jitter=svc.publish_backoff_jitter,
                dead_letter_dir=svc.dead_letter_dir, metrics=metrics)


def _urllib_transport(url: str, body: bytes) -> int:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    with urllib.request.urlopen(req, timeout=10.0) as resp:
        return int(resp.status)


class DatastorePublisher:
    """Publishes report batches; counts outcomes for observability.

    With an empty URL, publishing is a logged no-op (the reference's local /
    dev mode): reports are still returned to the caller, nothing leaves the
    process.

    Resilience (all opt-in; defaults reproduce the one-attempt behavior):

    - ``retries`` extra attempts per batch with bounded exponential
      backoff + deterministic jitter (faults.backoff_schedule — the same
      schedule a test can pin byte-for-byte);
    - ``dead_letter_dir``: batches that exhaust their retries are spooled
      to a durable JSONL file instead of dropped, and the spool REPLAYS
      automatically after the next successful POST (an outage sheds to
      disk; recovery drains it) — ``replay_dead_letters()`` is the
      explicit handle for drains/tests;
    - ``metrics``: a MetricsRegistry that mirrors the counters as the
      ``publish_retry`` / ``dead_letter`` gauges /stats exposes.

    Failures remain COUNTED, never silent: ``dropped`` keeps meaning
    "reports that left no trace" (only possible with no dead-letter dir).
    """

    def __init__(self, url: str = "", mode: str = "auto",
                 transport: Transport | None = None,
                 retries: int = 0, backoff_ms: float = 50.0,
                 backoff_cap_ms: float = 2000.0,
                 backoff_jitter: float = 0.1, backoff_seed: int = 0,
                 dead_letter_dir: str = "", metrics=None):
        self.url = url
        self.mode = mode
        self._transport = transport or _urllib_transport
        self.retries = int(retries)
        self._backoff = (float(backoff_ms) / 1e3,
                         float(backoff_cap_ms) / 1e3,
                         float(backoff_jitter), int(backoff_seed))
        self._metrics = metrics
        # counter guard: the scheduler's batch threads publish at once, and
        # the async subclass POSTs from its worker thread while histogram
        # flushes POST from the pipeline thread
        self._count_lock = locks.named_lock("publisher.counters")
        self.published = 0          # reports successfully POSTed
        self.dropped = 0            # reports lost to transport errors
        self.requests = 0           # POST attempts
        self.retried = 0            # attempts beyond the first, per batch
        self._backoff_serial = 0    # k-th retried batch (schedule key)
        self.json_failures = 0      # failed publish_json POSTs (flushes)
        self.dead_lettered = 0      # report rows spooled to disk
        self.dead_letter_replayed = 0   # rows replayed out of the spool
        self._spool_lock = locks.named_lock("publisher.spool")
        self._replay_busy = False      # one replay at a time (see
        #                                replay_dead_letters)
        self._spool_path = (os.path.join(dead_letter_dir,
                                         "dead_letter.jsonl")
                            if dead_letter_dir else "")
        self._spool_pending = 0     # report rows waiting in the spool
        if self._spool_path:
            os.makedirs(dead_letter_dir, exist_ok=True)
            self._spool_pending = self._spool_scan()
            self._gauges()

    # ---- dead-letter spool ----------------------------------------------

    def _spool_scan(self) -> int:
        """Rows pending in an inherited spool (a restarted worker keeps
        draining its predecessor's dead letters). A torn final line —
        killed mid-append, the chaos scenario — is TRUNCATED from the
        file before the next append can concatenate onto the fragment
        and weld two batches into one unparseable line that would
        wedge replay forever (same discipline as the broker logs)."""
        if not os.path.exists(self._spool_path):
            return 0
        rows = good = 0
        with open(self._spool_path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break              # torn tail from a mid-write death
                try:
                    rows += len(json.loads(line).get("reports", ())) or 1
                except json.JSONDecodeError:
                    break              # corrupt line: cut it and after
                good += len(line)
        if os.path.getsize(self._spool_path) > good:
            with open(self._spool_path, "rb+") as f:
                f.truncate(good)
        return rows

    def _spool_append(self, doc: dict, n_rows: int) -> None:
        with self._spool_lock:
            with open(self._spool_path, "ab") as f:
                f.write(json.dumps(doc, separators=(",", ":")).encode()
                        + b"\n")
                f.flush()
            self._spool_pending += n_rows
        with self._count_lock:
            self.dead_lettered += n_rows
        self._gauges()
        # flight-recorder post-mortem: a batch just exhausted its retries
        # — the dump shows what the pipeline was doing in the seconds
        # before the outage won (no-op unless tracing + dump dir are on)
        tracing.post_mortem("dead_letter", failing="publish",
                            rows=n_rows, pending=self._spool_pending)

    @property
    def dead_letter_pending(self) -> int:
        with self._spool_lock:
            return self._spool_pending

    def replay_dead_letters(self) -> "tuple[int, int]":
        """Drain the spool in order, stopping at the first still-failing
        POST; survivors are rewritten atomically. Returns (replayed_rows,
        remaining_rows). Called automatically after a successful publish;
        callable explicitly at drain/recovery time.

        The network attempts run WITHOUT the spool lock (a long replay
        must not freeze stats()/dead_letter_pending readers or a
        concurrent spool append); only the snapshot and the rewrite hold
        it. Replay successes are a PREFIX of the snapshot, and appends
        only ever extend the file, so the rewrite drops exactly the
        replayed prefix. One replay at a time (_replay_busy) — a second
        caller returns immediately rather than double-POSTing."""
        if not self._spool_path:
            return 0, 0
        with self._spool_lock:
            if self._replay_busy:
                return 0, self._spool_pending
            self._replay_busy = True
        replayed = n_ok = 0
        try:        # outermost: the busy latch must NEVER leak — a stuck
            #         latch would disable replay for the process lifetime
            try:
                with open(self._spool_path, "rb") as f:
                    lines = [ln for ln in f.read().splitlines() if ln]
            except FileNotFoundError:
                with self._spool_lock:
                    self._spool_pending = 0
                return 0, 0
            for ln in lines:                 # network leg: NO spool lock
                try:
                    doc = json.loads(ln)
                except json.JSONDecodeError:
                    break                    # torn tail: rows never counted
                if not self._attempt(json.dumps(doc).encode()):
                    break                    # outage persists: stop here
                n = len(doc.get("reports", ())) or 1
                replayed += n
                n_ok += 1
                with self._count_lock:
                    self.published += len(doc.get("reports", ()))
                    self.dead_letter_replayed += n
            with self._spool_lock:
                if n_ok:
                    # drop exactly the replayed prefix; lines appended
                    # meanwhile sit after it and survive the rewrite
                    with open(self._spool_path, "rb") as f:
                        cur = [ln for ln in f.read().splitlines() if ln]
                    keep = cur[n_ok:]
                    tmp = self._spool_path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(b"".join(ln + b"\n" for ln in keep))
                        f.flush()
                        # lint: allow[lock-blocking] 2026-10-17 the prefix
                        # rewrite must exclude concurrent appends or a
                        # just-spooled batch is lost in the replace; the
                        # POSTs already run outside this lock
                        # (concurrency_contract BLOCKING_ALLOW
                        # publisher.spool, os.fsync)
                        os.fsync(f.fileno())
                    os.replace(tmp, self._spool_path)
                    self._spool_pending = max(
                        0, self._spool_pending - replayed)
                remaining = self._spool_pending
        finally:
            with self._spool_lock:
                self._replay_busy = False
        self._gauges()
        return replayed, remaining

    def _gauges(self) -> None:
        if self._metrics is not None:
            with self._count_lock:
                retried, dead = self.retried, self.dead_lettered
            self._metrics.gauge("publish_retry", retried)
            self._metrics.gauge("dead_letter", self.dead_letter_pending)
            self._metrics.gauge("dead_letter_total", dead)

    def _attempt(self, payload: bytes) -> bool:
        """One transport attempt (no retries, no counting beyond the
        request counter) — the unit the retry loop and spool replay
        share. The ``publish`` fault site lives HERE, so an injected
        outage hits every path a real one would, and so do the
        ``publish_attempts`` / ``publish_failures`` counters (registry
        writes run outside the count lock)."""
        with self._count_lock:
            self.requests += 1
        if self._metrics is not None:
            self._metrics.count("publish_attempts")
        try:
            faults.fire("publish")
            status = self._transport(self.url, payload)
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            log.warning("datastore POST failed: %s", exc)
            if self._metrics is not None:
                self._metrics.count("publish_failures")
            return False
        if 200 <= status < 300:
            return True
        log.warning("datastore POST returned %d", status)
        if self._metrics is not None:
            self._metrics.count("publish_failures")
        return False

    def _post_with_retries(self, payload: bytes) -> bool:
        """Attempt + bounded exponential backoff. The jitter schedule for
        the k-th retried batch is a pure function of (publisher seed, k)
        — k is a dedicated per-publisher counter taken here, NOT the
        shared request counter, so concurrent publish_json traffic can't
        reshuffle which schedule a batch drew."""
        if self._attempt(payload):
            return True
        if self.retries:
            with self._count_lock:
                self._backoff_serial += 1
                k = self._backoff_serial
            base, cap, jit, seed = self._backoff
            for delay in faults.backoff_schedule(self.retries, base, cap,
                                                 jit, seed ^ k):
                time.sleep(delay)
                with self._count_lock:
                    self.retried += 1
                self._gauges()
                if self._attempt(payload):
                    return True
        return False

    def publish(self, reports: list[Report], on_done=None) -> bool:
        """POST one batch. True on success (or no-op); False on failure.
        ``on_done(ok)``, if given, runs after the attempt completes
        (synchronously here, on the worker thread in the async subclass),
        so callers sequence commit-floor releases alike against either
        publisher."""
        ok = self._publish_sync(reports)
        if on_done is not None:
            on_done(ok)
        return ok

    def _publish_sync(self, reports: list[Report]) -> bool:
        if not reports:
            return True
        if not self.url:
            log.debug("datastore disabled; dropping %d reports on the floor",
                      len(reports))
            return True
        return self._post([r.to_json() for r in reports])

    def publish_columns(self, seg, nxt, t0, t1, length, queue,
                        on_done=None) -> bool:
        """Columnar publish: the same ``{"mode", "reports": [...]}``
        payload as publish(), built straight from report columns
        (streaming/columnar.py), no Report objects."""
        ok = self._publish_columns_sync(seg, nxt, t0, t1, length, queue)
        if on_done is not None:
            on_done(ok)
        return ok

    def _publish_columns_sync(self, seg, nxt, t0, t1, length, queue) -> bool:
        if not len(seg):
            return True
        if not self.url:
            log.debug("datastore disabled; dropping %d reports on the floor",
                      len(seg))
            return True
        return self._post(_report_rows(seg, nxt, t0, t1, length, queue))

    def _post(self, report_rows: list[dict]) -> bool:
        doc = {"mode": self.mode, "reports": report_rows}
        if self._post_with_retries(json.dumps(doc).encode()):
            with self._count_lock:
                self.published += len(report_rows)
            if self.dead_letter_pending:
                try:
                    # the outage is over (a POST just landed): drain the
                    # spool opportunistically
                    self.replay_dead_letters()
                except Exception:   # a spool-IO error (ENOSPC…) must not
                    log.exception("dead-letter replay failed; spool kept")
            return True
        if self._spool_path:
            log.warning("datastore POST exhausted %d retries "
                        "(%d reports dead-lettered)", self.retries,
                        len(report_rows))
            self._spool_append(doc, len(report_rows))
        else:
            log.warning("datastore POST exhausted %d retries "
                        "(%d reports dropped)", self.retries,
                        len(report_rows))
            with self._count_lock:
                self.dropped += len(report_rows)
        return False

    def publish_json(self, payload: dict) -> bool:
        """POST an arbitrary JSON document. True on success or when
        publishing is disabled. Retries apply; the dead-letter spool does
        not (its caller retries the same document itself)."""
        if not self.url:
            return True
        if self._post_with_retries(json.dumps(payload).encode()):
            return True
        with self._count_lock:
            self.json_failures += 1
        return False

    # The async surface: no-ops here, so callers treat either publisher
    # alike; AsyncDatastorePublisher overrides the publish side.

    @property
    def pending(self) -> int:
        """Publishes accepted but not yet POSTed (0: sync publisher)."""
        return 0

    def drain(self, timeout: "float | None" = None) -> bool:
        return True

    def close(self) -> None:
        """Nothing to flush: every publish POSTs before it returns."""


class AsyncDatastorePublisher(DatastorePublisher):
    """DatastorePublisher whose report POSTs run on a background thread.

    The streaming flush loop must not serialize with datastore round
    trips: ``publish`` / ``publish_columns`` enqueue onto a bounded queue
    served by one worker and return at once; the worker's socket wait
    releases the GIL, so the POST of wave N-1 overlaps the match of wave
    N and the consume of wave N+1. A full queue blocks the caller
    (backpressure, never a silent drop). ``on_done(ok)`` callbacks, which
    the pipeline uses to release commit floors, run on the worker thread
    after the POST attempt completes, success or not.

    Histogram flushes (``publish_json``) stay synchronous on the caller:
    they are rare, and the delta-flush retry contract needs the result.
    """

    def __init__(self, url: str = "", mode: str = "auto",
                 transport: Transport | None = None,
                 max_pending: int = 64, **kw):
        super().__init__(url, mode, transport, **kw)
        self._jobs: "_queue.Queue" = _queue.Queue(maxsize=int(max_pending))
        self._thread: "threading.Thread | None" = None
        self._closed = False

    @property
    def pending(self) -> int:
        return self._jobs.qsize()

    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="datastore-publisher")
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                fn, on_done, n_rows = job
                ok = False
                try:
                    with tracing.tracer().span("publish_post",
                                               rows=n_rows):
                        ok = fn()
                except Exception:
                    # _post catches only transport-shaped errors; anything
                    # else (a bad URL scheme, a garbled response, a
                    # transport bug) counts as a failed attempt instead of
                    # killing the worker: a dead worker never fires
                    # on_done, which would wedge every pending wave's
                    # commit floor and hang drain() / close()
                    log.exception("datastore publish job raised "
                                  "(%d reports dropped)", n_rows)
                    with self._count_lock:
                        self.dropped += n_rows
                finally:
                    if on_done is not None:
                        try:
                            on_done(ok)
                        except Exception:   # a callback bug must not kill
                            log.exception("publish on_done callback failed")
            finally:
                self._jobs.task_done()

    def _submit(self, fn, on_done, n_rows: int) -> bool:
        if self._closed:
            raise RuntimeError("publisher is closed")
        self._ensure_worker()
        self._jobs.put((fn, on_done, n_rows))
        return True

    def publish(self, reports: list[Report], on_done=None) -> bool:
        """Enqueue one report-batch POST; True = accepted (the outcome is
        counted on the worker and delivered to ``on_done``)."""
        if not reports or not self.url:
            if reports:
                log.debug("datastore disabled; dropping %d reports on the "
                          "floor", len(reports))
            if on_done is not None:
                on_done(True)
            return True
        rows = [r.to_json() for r in reports]
        return self._submit(lambda: self._post(rows), on_done, len(rows))

    def publish_columns(self, seg, nxt, t0, t1, length, queue,
                        on_done=None) -> bool:
        """Columnar twin of publish(): the rows are built here, on the
        caller's thread, so the numpy columns are free at return."""
        if not len(seg) or not self.url:
            if len(seg):
                log.debug("datastore disabled; dropping %d reports on the "
                          "floor", len(seg))
            if on_done is not None:
                on_done(True)
            return True
        rows = _report_rows(seg, nxt, t0, t1, length, queue)
        return self._submit(lambda: self._post(rows), on_done, len(rows))

    def drain(self, timeout: "float | None" = None) -> bool:
        """Block until every accepted publish has completed its POST
        attempt. ``timeout`` bounds the wait; True = fully drained."""
        if self._thread is None:
            return True
        if timeout is None:
            self._jobs.join()
            return True
        deadline = time.monotonic() + timeout
        while self._jobs.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def close(self) -> None:
        """Drain, then stop the worker (idempotent)."""
        if self._closed:
            return
        self.drain()
        self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join(timeout=5.0)
