"""Continuous in-flight batching for the serving face.

Counterpart: reporter_tpu/service/scheduler.py (``BatchScheduler``,
``ServiceOverloaded``, ``_rung``), with its contracts unchanged:

  - requests enqueue into a BOUNDED admission queue (full ⇒ 503, a
    counted rejection);
  - a scheduler thread closes batches by SIZE (``max_batch_traces``) or
    by DEADLINE (``batch_close_ms`` after the oldest admitted request — a
    lone request is never stuck waiting for peers);
  - closed batches are PADDED to trace-count rungs within each point
    bucket (padding rows are clones of real traces; decode is
    independent of batch composition, so results are unchanged);
  - up to ``max_inflight_batches`` worker threads run batches at once;
  - completions route back to per-request futures; a uuid already in an
    in-flight batch DEFERS later requests for it (and everything queued
    behind them for the same uuid), so per-uuid cache merge/retain order
    is the sequential path's;
  - errors are isolated: a failed batch is retried per submission, in
    arrival order, so one poisoned request fails alone;
  - ``close()`` drains: the queue flushes (deadlines waived), new
    admissions get 503.

The queue-and-combine path stays selectable
(``ServiceConfig.batching = "combine"``) for A/B runs.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Sequence

from reporter_tpu_torch.utils import locks, tracing
from reporter_tpu_torch.utils.readahead import ReadAheadWorker

if TYPE_CHECKING:                            # pragma: no cover
    from reporter_tpu_torch.matcher.api import Trace
    from reporter_tpu_torch.service.app import ReporterApp


class ServiceOverloaded(RuntimeError):
    """Admission queue full or service shutting down → HTTP 503."""


# Trace-count rungs: a closed batch's per-point-bucket group is padded up
# to the next rung, as the JAX package pads it (there, so the jitted wire
# executable's [B, T] shape comes from a small fixed set). The port
# compiles nothing per shape, so padding buys it no recompile; it is kept
# so a batch's trace set, and so its Morton order and slices, are the JAX
# package's, and its cost is priced (sched_batch_occupancy,
# padding_by_bucket).
_TRACE_RUNGS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _rung(n: int) -> int:
    for r in _TRACE_RUNGS:
        if n <= r:
            return r
    return n


class _ScheduledSubmission:
    """One report_many call: validated pairs + a completion future.
    (Distinct from app.py's legacy combine-path ``_Submission``: this one
    carries admission-time and deferral bookkeeping the combine leader
    has no use for.)"""

    __slots__ = ("pairs", "uuids", "done", "results", "error", "t_enqueue",
                 "was_deferred")

    def __init__(self, pairs, t_enqueue: float):
        self.pairs = pairs
        self.uuids = frozenset(u for u, _ in pairs)
        self.done = threading.Event()
        self.results: list[dict] = []
        self.error: "Exception | None" = None
        self.t_enqueue = t_enqueue
        self.was_deferred = False


class BatchScheduler:
    """SLO-aware request scheduler keeping the device pipeline full.

    Owns one scheduler thread (batch assembly) and a small DAEMON worker
    pool (``max_inflight_batches`` workers running the match+publish
    pipeline; each worker's wait on the card releases the GIL, so
    batches may overlap). Daemon, not concurrent.futures: the stdlib
    executor's atexit hook joins its non-daemon workers unconditionally,
    so one wedged dispatch would block process exit no matter what
    close() decided; daemon workers keep the bounded drain real. The
    app's cache, publisher and matcher are thread-safe. Per-uuid
    ordering is enforced here by deferral; everything else runs
    concurrently.
    """

    def __init__(self, app: "ReporterApp", clock=time.monotonic):
        svc = app.config.service
        self.app = app
        self.metrics = app.matcher.metrics
        self.batch_close_s = float(svc.batch_close_ms) / 1e3
        self.max_batch = int(svc.max_batch_traces)
        self.max_inflight = int(svc.max_inflight_batches)
        self.limit = int(svc.admission_queue_limit)
        self._clock = clock
        self._cv = locks.named_condition("scheduler.cv")
        self._queue: "deque[_ScheduledSubmission]" = deque()
        self._queued_traces = 0
        self._dispatch_serial = 0      # batch id for trace spans (under _cv)
        self._inflight = 0
        self._inflight_uuids: set[str] = set()
        self._closed = False
        self._stats_lock = locks.named_lock("scheduler.stats")
        self.stats = {"batches": 0, "submissions": 0, "padded_traces": 0,
                      "deferred": 0, "rejected": 0, "isolated_retries": 0,
                      "max_inflight_seen": 0}
        self.inflight_hist: dict[int, int] = {}   # dispatches at depth k
        self.padding_by_bucket: dict[int, int] = {}
        # Prepare-ahead: a closed batch's dispatch-free head
        # (cache merge, Trace build, padding, the matcher's prepared
        # seam — app._prefab_validated) runs on a read-ahead thread
        # while earlier batches occupy the device. Per-uuid deferral
        # makes it safe: a batch only closes with uuids disjoint from
        # every in-flight batch, so the prefab reads exactly the cache
        # tails an inline call would. Off (pipeline_prepare=False) =
        # the serial arm, workers compute the head inline.
        self._prefab = (ReadAheadWorker(name="sched-prepare")
                        if svc.pipeline_prepare else None)
        self._work: "_queue.Queue" = _queue.Queue()
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"reporter-batch-{i}")
            for i in range(self.max_inflight)]
        for w in self._workers:
            w.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="reporter-scheduler")
        self._thread.start()

    def _worker_loop(self) -> None:
        while True:
            job = self._work.get()
            if job is None:
                return
            self._run_batch(*job)

    # ---- request side ----------------------------------------------------

    def submit(self, pairs: "list[tuple[str, list[dict]]]") -> list[dict]:
        """Admit validated pairs, block until the batch pipeline resolves
        them. Raises the request's own error; ServiceOverloaded when the
        admission queue is full or the scheduler is shut down."""
        with self._cv:
            if self._closed:
                raise ServiceOverloaded("service is shutting down")
            queued = self._queued_traces
            if queued + len(pairs) > self.limit and self._queue:
                # Always admit into an empty queue: a single oversized
                # report_many must not be unservable.
                with self._stats_lock:
                    self.stats["rejected"] += 1
                sub = None
            else:
                sub = _ScheduledSubmission(pairs, self._clock())
                self._queue.append(sub)
                self._queued_traces += len(pairs)
                self.metrics.gauge("sched_admission_depth",
                                   len(self._queue))
                self._cv.notify_all()
        if sub is None:
            # post-mortem OUTSIDE _cv: dumping the ring is disk I/O and
            # must not stall every concurrent submit() plus the dispatch
            # thread at exactly the overload peak (the other fault sites
            # all dump outside their locks too)
            tracing.post_mortem("shed", failing="admission",
                                queued_traces=queued, limit=self.limit)
            raise ServiceOverloaded(
                f"admission queue full ({queued} traces "
                f"queued, limit {self.limit})")
        while not sub.done.wait(timeout=5.0):
            with self._cv:
                closed = self._closed
            # During a graceful close the scheduler thread exits as soon
            # as the queue is flushed while OUR batch may still ride the
            # card on an executor worker — that is drain, not death: keep
            # waiting for the completion close() guarantees. Thread death
            # with the scheduler OPEN is a real bug -> fail loudly.
            if (not closed and not self._thread.is_alive()
                    and not sub.done.is_set()):
                raise RuntimeError("scheduler thread died")   # pragma: no cover
        if sub.error is not None:
            raise sub.error
        return sub.results

    # ---- scheduler thread ------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                batch = None
                while batch is None:
                    if self._closed and not self._queue:
                        return
                    batch, wait = self._try_close_locked()
                    if batch is None:
                        self._cv.wait(timeout=wait)
                uuids = frozenset().union(*(s.uuids for s in batch))
                self._inflight += 1
                self._inflight_uuids |= uuids
                depth = self._inflight
                self.metrics.gauge("sched_inflight_batches", depth)
                self.metrics.gauge("sched_admission_depth", len(self._queue))
                # hand off UNDER _cv: close() clears the queue and enqueues
                # the worker sentinels in one _cv section, so a dispatched
                # batch is always FIFO-ahead of every sentinel — a job can
                # never land behind them and starve its clients. The batch
                # serial rides in the job: a worker reading a shared
                # counter later would race other dispatches' increments
                # and mis-tag its trace spans.
                serial = self._dispatch_serial
                self._dispatch_serial += 1
                # prepare-ahead ticket UNDER _cv too: the worker may pop
                # the job immediately, so the ticket must exist before
                # the put. (scheduler.cv → readahead.tasks is a dated
                # contract edge; the submit only appends to a deque.)
                ticket = None
                if self._prefab is not None:
                    combined = [pair for s in batch for pair in s.pairs]
                    ticket = self._prefab.submit(
                        lambda c=combined: self.app._prefab_validated(c))
                self._work.put((batch, uuids, serial, ticket))
            now = self._clock()
            for s in batch:
                self.metrics.observe("sched_queue_age_seconds",
                                     now - s.t_enqueue)
            with self._stats_lock:
                # hist writes share _stats_lock with snapshot()'s copy —
                # a /health racing a dispatch must never see a mid-insert
                # dict
                self.inflight_hist[depth] = self.inflight_hist.get(depth,
                                                                   0) + 1
                self.stats["batches"] += 1
                self.stats["submissions"] += len(batch)
                self.stats["max_inflight_seen"] = max(
                    self.stats["max_inflight_seen"], depth)
            # keep the app's device-batch counters meaningful in either
            # batching mode (bench A/B and /health read the same keys)
            with self.app._stats_lock:
                self.app.stats["batches"] += 1
                self.app.stats["batched_submissions"] += len(batch)

    def _try_close_locked(self):
        """(batch, None) when a batch should dispatch now, else
        (None, seconds-to-wait | None). Runs under self._cv."""
        if self._inflight >= self.max_inflight:
            return None, None          # a completion will notify
        blocked = set(self._inflight_uuids)
        ready: list[_ScheduledSubmission] = []
        n_traces = 0
        for sub in self._queue:
            if n_traces >= self.max_batch:
                break
            if blocked and (sub.uuids & blocked):
                # per-uuid ordering: this submission waits for the
                # in-flight batch holding its uuid, and so does every
                # later submission sharing a uuid with IT (counted once,
                # at its eventual dispatch)
                blocked |= sub.uuids
                sub.was_deferred = True
                continue
            ready.append(sub)
            n_traces += len(sub.pairs)
        if not ready:
            return None, None
        age = self._clock() - ready[0].t_enqueue
        if (n_traces >= self.max_batch or age >= self.batch_close_s
                or self._closed):
            taken = set(map(id, ready))
            self._queue = deque(s for s in self._queue
                                if id(s) not in taken)
            self._queued_traces -= n_traces
            deferred = sum(1 for s in ready if s.was_deferred)
            if deferred:
                with self._stats_lock:
                    self.stats["deferred"] += deferred
            return ready, None
        return None, max(1e-4, self.batch_close_s - age)

    # ---- executor side ---------------------------------------------------

    def _run_batch(self, batch: "list[_ScheduledSubmission]", uuids,
                   serial: int, ticket=None) -> None:
        try:
            combined = [pair for s in batch for pair in s.pairs]
            with tracing.tracer().span("sched_batch", wave=serial,
                                       submissions=len(batch),
                                       traces=len(combined)):
                self._run_batch_traced(batch, combined, ticket)
        except Exception as exc:
            for s in batch:
                s.error = exc
        finally:
            with self._cv:
                self._inflight -= 1
                self._inflight_uuids -= uuids
                self.metrics.gauge("sched_inflight_batches", self._inflight)
                self._cv.notify_all()
            for s in batch:
                s.done.set()

    def _run_batch_traced(self, batch: "list[_ScheduledSubmission]",
                          combined, ticket=None) -> None:
        try:
            prefab = None
            if ticket is not None:
                try:
                    prefab = ticket.result()
                except Exception:
                    # prepare-ahead failure (incl. a closed read-ahead
                    # worker during drain) degrades to the inline head —
                    # same work, same error surface, just not overlapped
                    prefab = None
            results = self.app._process_validated(combined, prefab=prefab)
            lo = 0
            for s in batch:
                s.results = results[lo:lo + len(s.pairs)]
                lo += len(s.pairs)
        except Exception:
            # Error isolation: retry per submission, in arrival order
            # (preserves duplicate-uuid sequencing). A request that
            # fails ALONE owns its error; co-batched requests are
            # still served. Single-submission batches skip the retry
            # — the batched attempt WAS the isolated attempt.
            if len(batch) == 1:
                raise
            with self._stats_lock:
                self.stats["isolated_retries"] += 1
            for s in batch:
                try:
                    s.results = self.app._process_validated(s.pairs)
                except Exception as exc:
                    s.error = exc

    # ---- shape-bucket padding -------------------------------------------

    def pad_traces(self, traces: "Sequence[Trace]") -> "list[Trace]":
        """Pad a closed batch to the trace-count rungs: within
        each max-point bucket, clone that bucket's first trace until the
        trace count hits the next rung. Called by the app right before
        ``match_many``; padded rows ride the dispatch and their results
        are dropped (the app zips results against real items only), so
        the only cost is occupancy — which is what the waste metrics
        price."""
        from reporter_tpu_torch.matcher.api import _bucket_len

        groups: dict[int, int] = {}
        templates: dict[int, "Trace"] = {}
        for t in traces:
            b = _bucket_len(len(t.xy))
            groups[b] = groups.get(b, 0) + 1
            templates.setdefault(b, t)
        pad: list = []
        with self._stats_lock:
            for b, n in groups.items():
                deficit = _rung(n) - n
                if deficit:
                    pad.extend([templates[b]] * deficit)
                    self.stats["padded_traces"] += deficit
                    self.padding_by_bucket[b] = (
                        self.padding_by_bucket.get(b, 0) + deficit)
        total = len(traces) + len(pad)
        if total:
            self.metrics.observe("sched_batch_occupancy",
                                 len(traces) / total)
        if pad:
            self.metrics.count("sched_padded_traces", len(pad))
        return list(traces) + pad

    # ---- observability / lifecycle --------------------------------------

    def snapshot(self) -> dict:
        """Scheduler state for /health: operators see saturation without
        the metrics port (admission depth, in-flight, counters)."""
        with self._cv:
            depth, traces = len(self._queue), self._queued_traces
            inflight, closed = self._inflight, self._closed
        with self._stats_lock:
            return {
                "admission_depth": depth,
                "admission_traces": traces,
                "admission_limit": self.limit,
                "inflight_batches": inflight,
                "max_inflight_batches": self.max_inflight,
                "batch_close_ms": self.batch_close_s * 1e3,
                "max_batch_traces": self.max_batch,
                "inflight_hist": dict(self.inflight_hist),
                "padding_by_bucket": dict(self.padding_by_bucket),
                "draining": closed,
                # the matcher's dispatch watchdog counts
                "dispatch_timeouts": int(
                    self.metrics.value("dispatch_timeout")),
                "dispatch_fallbacks": int(
                    self.metrics.value("dispatch_fallback")),
                **self.stats,
            }

    def close(self, timeout: "float | None" = 30.0) -> None:
        """Graceful drain: stop admitting (new submits → 503), flush the
        queue (deadlines are waived — everything closes now), join the
        in-flight batches. ``timeout`` bounds the WHOLE drain: a dispatch
        wedged on a hung device must not
        wedge shutdown with it — on timeout the daemon workers are
        abandoned (never joined at process exit) and every submission
        still queued or riding a wedged batch is failed with
        ServiceOverloaded so no client thread waits forever. Idempotent."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def _left(floor: float = 0.0) -> "float | None":
            if deadline is None:
                return None
            return max(floor, deadline - time.monotonic())

        with self._cv:
            already = self._closed
            self._closed = True
            self._cv.notify_all()
        if already:
            return
        self._thread.join(timeout=_left())
        abandoned: "list[_ScheduledSubmission]" = []
        with self._cv:
            # wait for BOTH the queue and the in-flight count to drain;
            # a still-alive scheduler thread (timed-out join above) keeps
            # dispatching during this window — that is the drain working
            while self._inflight > 0 or self._queue:
                wait = _left()
                if wait is not None and wait <= 0:
                    break
                self._cv.wait(timeout=wait)
            if self._inflight > 0 or self._queue:
                # timed-out drain (wedged dispatch): whatever is still queued
                # will never dispatch — resolve those clients with the
                # drain status instead of leaving them blocked. In-flight
                # batches' clients resolve if/when the wedge clears (the
                # workers are daemons; process exit is never blocked).
                abandoned = list(self._queue)
                self._queue.clear()
                self._queued_traces = 0
            # sentinels inside the SAME _cv section that emptied the
            # queue: every dispatched batch reached the work queue under
            # _cv before this point, so the sentinels are FIFO-behind all
            # real jobs and no job can land after them (nothing is left
            # to dispatch, and new submits are refused)
            for _ in self._workers:
                self._work.put(None)
            self._cv.notify_all()
        for s in abandoned:
            s.error = ServiceOverloaded("service drain timed out")
            s.done.set()
        for w in self._workers:
            w.join(timeout=_left(0.1))
        if self._prefab is not None:
            # after the workers: a draining worker's ticket must resolve
            # before the read-ahead thread goes away (an unstarted
            # ticket fails loudly and the worker recomputes inline)
            self._prefab.close(timeout=_left(0.1))
        self.metrics.gauge("sched_inflight_batches", 0)
        self.metrics.gauge("sched_admission_depth", 0)
