"""Sampled shadow-oracle audits: ground truth for the served matches.

Counterpart: reporter_tpu/quality/audit.py (``ShadowAuditor``,
``auditor``, ``configure``, ``maybe_audit``), with the same environment
variables, defaults and seeded schedule. The window sentinel
(quality/monitor.py) watches proxies; this module measures the real
thing on a few batches: a seeded sampler diverts a small share of served
device batches to the exact-Dijkstra oracle (``reference_cpu``) on one
background thread and counts their length-weighted segment disagreement
(matcher/fidelity.py).

  - The sampling decision is a counted draw from ``random.Random`` seeded
    by ``RTPU_QUALITY_SEED``, so one seed replays one schedule, in either
    package.
  - The serving thread pays one decision under a leaf lock and an
    enqueue. The oracle runs on the auditor's thread, bounded by its own
    watchdog (cap 2): a wedged oracle is abandoned and counted, never
    waited for by serving.
  - The cost is bounded absolutely: at most one audit per
    ``min_interval_s`` of wall time (the first waits one interval after
    the auditor's birth), none while the measured duty (audit seconds
    over uptime) is above ``duty_pct_cap``, at most ``queue_cap`` queued,
    and ``max_traces`` traces an audit.
  - One auditor per process (``auditor()``, built lazily from the
    environment; ``configure()`` swaps it).

Each matcher gets its own oracle for audits, built with its quality
telemetry off and dropped after a timeout (the abandoned thread keeps
its Dijkstra cache, which is not thread-safe).

Environment: RTPU_QUALITY_AUDIT_RATE (default 1/256 of batches),
RTPU_QUALITY_AUDIT_TRACES (2), RTPU_QUALITY_AUDIT_TIMEOUT_S (20),
RTPU_QUALITY_AUDIT_DUTY_PCT (1.0), RTPU_QUALITY_AUDIT_MIN_INTERVAL_S
(60), RTPU_QUALITY_SEED (0).
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time
import zlib

from reporter_tpu_torch.utils import locks
from reporter_tpu_torch.utils.metrics import labeled
from reporter_tpu_torch.utils.watchdog import (TIMED_OUT,
                                               AbandonedThreadWatchdog)

__all__ = ["ShadowAuditor", "auditor", "configure", "maybe_audit"]

_ENV_RATE = "RTPU_QUALITY_AUDIT_RATE"
_ENV_TRACES = "RTPU_QUALITY_AUDIT_TRACES"
_ENV_TIMEOUT = "RTPU_QUALITY_AUDIT_TIMEOUT_S"
_ENV_DUTY = "RTPU_QUALITY_AUDIT_DUTY_PCT"
_ENV_INTERVAL = "RTPU_QUALITY_AUDIT_MIN_INTERVAL_S"
_ENV_SEED = "RTPU_QUALITY_SEED"

# about one audited batch per 256 served; the interval and the duty cap
# bound the cost, since a per-batch rate scales with traffic
_DEFAULT_RATE = 1.0 / 256.0


class _Job:
    __slots__ = ("matcher", "traces", "result", "k")

    def __init__(self, matcher, traces, result, k):
        self.matcher = matcher
        self.traces = traces
        self.result = result
        self.k = k


class ShadowAuditor:
    """Seeded sampler and bounded background oracle worker."""

    def __init__(self, rate: "float | None" = None,
                 max_traces: "int | None" = None,
                 timeout_s: "float | None" = None,
                 duty_pct_cap: "float | None" = None,
                 min_interval_s: "float | None" = None,
                 seed: "int | None" = None,
                 queue_cap: int = 4,
                 clock=time.monotonic):
        e = os.environ
        self.rate = float(rate if rate is not None
                          else e.get(_ENV_RATE, str(_DEFAULT_RATE)))
        self.max_traces = int(max_traces if max_traces is not None
                              else e.get(_ENV_TRACES, "2"))
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else e.get(_ENV_TIMEOUT, "20"))
        self.duty_pct_cap = float(duty_pct_cap if duty_pct_cap is not None
                                  else e.get(_ENV_DUTY, "1.0"))
        self.min_interval_s = float(
            min_interval_s if min_interval_s is not None
            else e.get(_ENV_INTERVAL, "60"))
        seed = int(seed if seed is not None else e.get(_ENV_SEED, "0"))
        # a crc32 salt, not hash(): string hashing is randomized per
        # process, and a worker subprocess must replay the schedule
        self._rng = random.Random((seed << 8)
                                  ^ (zlib.crc32(b"quality_audit")
                                     & 0xFFFF))
        self.clock = clock
        self._lock = locks.named_lock("quality.audit")
        self._queue: "collections.deque[_Job]" = collections.deque()
        self._queue_cap = int(queue_cap)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._busy = False
        self._watchdog = AbandonedThreadWatchdog(
            cap=2, thread_name="quality-audit")
        self._born = clock()
        # stamped at birth: the first audit also waits one interval, out
        # of the process's start-up
        self._last_enqueue = clock()
        # counted outcomes, under self._lock
        self.calls = 0
        self.sampled = 0
        self.skipped_budget = 0
        self.skipped_interval = 0
        self.skipped_queue = 0
        self.audited_batches = 0
        self.audited_traces = 0
        self.audit_timeouts = 0
        self.audit_seconds_total = 0.0
        self.disagreement_sum = 0.0

    # ---- the serving thread's side ---------------------------------------

    def maybe_audit(self, matcher, traces, result) -> bool:
        """One counted sampling decision; a selected batch enqueues
        (matcher, its first ``max_traces`` traces, result), and the
        records are built and the oracle run on the worker. → whether
        the batch was enqueued."""
        if self.rate <= 0.0 or not len(traces):
            return False
        # the breaker read takes the watchdog's own lock: read it before
        # the audit lock rather than nest the two
        breaker_open = self._watchdog.tripped
        with self._lock:
            self.calls += 1
            pick = self._rng.random() < self.rate
            if not pick:
                return False
            now = self.clock()
            if now - self._last_enqueue < self.min_interval_s:
                self.skipped_interval += 1
                return False
            if self._duty_pct_locked() > self.duty_pct_cap:
                self.skipped_budget += 1
                return False
            if len(self._queue) >= self._queue_cap or breaker_open:
                # sampling never becomes backpressure on serving
                self.skipped_queue += 1
                return False
            k = min(self.max_traces, len(traces))
            self._queue.append(_Job(matcher, list(traces[:k]), result, k))
            self._last_enqueue = now
            self.sampled += 1
        self._ensure_worker()
        self._wake.set()
        return True

    # ---- worker ----------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="quality-audit")
            # started inside the lock: two enqueues racing must not both
            # start one Thread
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                job = self._queue.popleft() if self._queue else None
                self._busy = job is not None
            if job is None:
                self._wake.wait(0.25)
                self._wake.clear()
                continue
            try:
                self._run_audit(job)
            except Exception:
                # an audit fault must not kill the worker (an oracle that
                # raises or hangs is counted in _run_audit)
                pass
            finally:
                with self._lock:
                    self._busy = False

    def _audit_oracle(self, matcher):
        """This matcher's own reference_cpu oracle for audits, not the
        dispatch fallback's (an audit must never hold the fallback lock
        serving degrades under). Touched only by the worker thread."""
        fb = getattr(matcher, "_quality_audit_oracle", None)
        if fb is None:
            import dataclasses

            from reporter_tpu_torch.matcher.api import SegmentMatcher
            fb = SegmentMatcher(
                matcher.ts, dataclasses.replace(
                    matcher.config, matcher_backend="reference_cpu"))
            # the oracle's own telemetry stays off: its sentinel would
            # run over 2-trace batches into a registry nothing reads
            fb.quality.enabled = False
            matcher._quality_audit_oracle = fb
        return fb

    def _run_audit(self, job: _Job) -> None:
        """One audit: the served records of the sampled traces against
        the oracle's, under the watchdog; the disagreement goes to the
        matcher's registry."""
        from reporter_tpu_torch.matcher.fidelity import mean_disagreement

        served = [list(job.result[i]) for i in range(job.k)]
        matcher = job.matcher
        fb = self._audit_oracle(matcher)

        def run():
            return [list(r) for r in fb.match_many(job.traces)]

        t0 = time.perf_counter()
        out = self._watchdog.run(run, self.timeout_s)
        dt = time.perf_counter() - t0
        metro = matcher.ts.name
        reg = matcher.metrics
        if out is TIMED_OUT:
            # the abandoned thread still owns the oracle's cache: the next
            # audit builds a fresh oracle
            matcher._quality_audit_oracle = None
            with self._lock:
                self.audit_timeouts += 1
                self.audit_seconds_total += dt
            reg.count(labeled("quality_audit_timeouts", metro=metro))
            return
        dis = mean_disagreement(served, out)
        with self._lock:
            self.audited_batches += 1
            self.audited_traces += job.k
            self.audit_seconds_total += dt
            self.disagreement_sum += dis
        # registry writes outside the auditor's lock (a leaf lock)
        reg.count(labeled("quality_audit_batches", metro=metro))
        reg.count(labeled("quality_audit_traces", metro=metro), job.k)
        reg.observe(labeled("quality_audit_disagreement", metro=metro), dis)
        reg.observe(labeled("quality_audit_seconds", metro=metro), dt)

    # ---- read side and lifecycle ------------------------------------------

    def _duty_pct_locked(self) -> float:
        up = max(self.clock() - self._born, 1e-6)
        return 100.0 * self.audit_seconds_total / up

    def duty_pct(self) -> float:
        """The audit duty measured over the auditor's lifetime (%)."""
        with self._lock:
            return round(self._duty_pct_locked(), 4)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for the queue to empty and the running audit to land;
        True when drained within the bound."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._queue and not self._busy
            if idle:
                return True
            time.sleep(0.01)
        return False

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def stats(self) -> dict:
        with self._lock:
            batches = self.audited_batches
            return {
                "audit_rate": self.rate,
                "audit_calls": self.calls,
                "audited_batches": batches,
                "audited_traces": self.audited_traces,
                "audit_timeouts": self.audit_timeouts,
                "audit_skips": (self.skipped_budget + self.skipped_queue
                                + self.skipped_interval),
                "audit_seconds": round(self.audit_seconds_total, 4),
                "audit_duty_pct": round(self._duty_pct_locked(), 4),
                "disagreement_rate": (
                    None if not batches
                    else round(self.disagreement_sum / batches, 4)),
            }


# ---------------------------------------------------------------------------
# the process's auditor: one audit thread and one duty budget per process

_global: "ShadowAuditor | None" = None
_global_lock = locks.named_lock("quality.registry")


def auditor() -> ShadowAuditor:
    """The process auditor, built from the environment on first use."""
    global _global
    with _global_lock:
        if _global is None:
            _global = ShadowAuditor()
        return _global


def configure(a: "ShadowAuditor | None") -> None:
    """Swap the process auditor (None: build lazily again). Restore the
    previous one in a finally."""
    global _global
    with _global_lock:
        _global = a


def maybe_audit(matcher, traces, result) -> bool:
    """The matcher's hook: one decision against the process auditor, for
    device harvests only (the matcher gates that)."""
    return auditor().maybe_audit(matcher, traces, result)
