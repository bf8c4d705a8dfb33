"""Span tracing and the flight recorder.

Counterpart: reporter_tpu/utils/tracing.py (``FlightRecorder``,
``tracer``, ``span``, ``configure``, ``configure_from_service``,
``post_mortem``, ``env_flag``, ``trace_id_of``). One PROCESS-GLOBAL recorder: a bounded
ring of host-side spans, off by default (a disabled recorder costs one
attribute read per call site), that dumps a Chrome-trace-event JSON on
demand and, at the fault sites (the publisher's dead letter, the
scheduler's admission shed, the quality drift sentinel), a post-mortem
naming the failing span. Enablement layers as in the JAX package:

  - env: ``RTPU_TRACE=1`` (+ ``RTPU_TRACE_DIR=/dir`` for post-mortem
    dumps, ``RTPU_TRACE_RING=N`` for the ring's capacity);
  - config: ``ServiceConfig(trace=True, trace_dir=..., trace_ring=...)``
    applied at ReporterApp construction;
  - programmatic: ``tracing.configure(enabled=True, dump_dir=...)``.

Span timestamps are ``time.monotonic`` seconds; dumps convert to the
Chrome trace format's microseconds.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any

from reporter_tpu_torch.utils import locks

__all__ = ["FlightRecorder", "Span", "tracer", "configure", "span",
           "post_mortem", "NOOP", "env_flag", "configure_from_service",
           "TRACE_KEY", "stamp_record", "trace_id_of"]

# Broker-propagated trace context. A producer may stamp a probe record
# with ``record[TRACE_KEY] = {"id": ..., "ts": wall}`` before appending it
# to a record broker, which stores dicts verbatim; consumers that know
# the key tag their spans with the inherited id (streaming/pipeline.py),
# consumers that do not ignore an extra key. The columnar broker does not
# carry it.

TRACE_KEY = "_trace"


def stamp_record(record: dict, trace_id, ts: "float | None" = None) -> dict:
    """Attach producer-side trace context to one broker record (in place;
    returned for chaining). ``ts`` is wall time (``time.time()``)."""
    record[TRACE_KEY] = {"id": str(trace_id),
                         "ts": time.time() if ts is None else float(ts)}
    return record


def trace_id_of(record) -> "str | None":
    """The inherited trace id of a broker record, or None when the record
    is untraced (absent or malformed metadata reads as untraced, never as
    an error: a poisoned producer must not wedge consumption)."""
    meta = record.get(TRACE_KEY) if isinstance(record, dict) else None
    if isinstance(meta, dict) and meta.get("id") is not None:
        return str(meta["id"])
    return None

class Span:
    """One completed host-side interval. ``wave`` carries the
    wave/batch id propagated through the pipeline (None for spans
    outside a wave); ``args`` is the small free-form payload that lands
    in the Chrome event's ``args``."""

    __slots__ = ("name", "t0", "t1", "tid", "wave", "args")

    def __init__(self, name: str, t0: float, t1: float, tid: int,
                 wave: "int | None" = None,
                 args: "dict | None" = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.wave = wave
        self.args = args

    def to_event(self) -> dict:
        """Chrome trace-event ("X" = complete event; µs timestamps)."""
        ev: dict[str, Any] = {
            "name": self.name, "ph": "X", "pid": os.getpid(),
            "tid": self.tid, "ts": round(self.t0 * 1e6, 1),
            "dur": round(max(0.0, self.t1 - self.t0) * 1e6, 1),
        }
        args = dict(self.args) if self.args else {}
        if self.wave is not None:
            args["wave"] = self.wave
        if args:
            ev["args"] = args
        return ev


class _Instant(Span):
    """Point-in-time marker (fault fired, dispatch started)."""

    __slots__ = ()

    def to_event(self) -> dict:
        ev = super().to_event()
        ev["ph"] = "i"
        ev["s"] = "p"                 # process-scoped instant
        ev.pop("dur", None)
        return ev


class _NoopSpan:
    """Shared do-nothing context manager: what ``span()`` hands out when
    tracing is off, so the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager that records one Span into the ring on exit."""

    __slots__ = ("_rec", "_name", "_wave", "_args", "_t0")

    def __init__(self, rec: "FlightRecorder", name: str,
                 wave: "int | None", args: "dict | None"):
        self._rec = rec
        self._name = name
        self._wave = wave
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.add(self._name, self._t0, time.monotonic(),
                      wave=self._wave, **(self._args or {}))


class FlightRecorder:
    """Bounded ring of recent spans + the post-mortem dump machinery.

    Thread-safety: the ring is a ``deque(maxlen=...)`` and every span is
    appended as ONE completed object — appends from concurrent threads
    interleave at whole-span granularity (GIL-atomic), never inside a
    span, so no lock sits on the record path. Dumps snapshot the ring
    under a lock that only other dumps contend on.
    """

    def __init__(self, capacity: int = 4096):
        self.enabled = False
        self.dump_dir = ""
        self.max_dumps = 16
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=int(capacity))
        self._dump_lock = locks.named_lock("tracer.dump")
        self._dump_seq = 0
        self.dumps_written = 0
        self.dumps_suppressed = 0     # past max_dumps (counted, not silent)
        self._tids: dict[int, int] = {}   # thread ident → small stable id
        self._tid_lock = locks.named_lock("tracer.tid")  # its own lock: dump() calls
        #                                     _tid while holding _dump_lock

    # ---- configuration ---------------------------------------------------

    def configure(self, enabled: "bool | None" = None,
                  dump_dir: "str | None" = None,
                  capacity: "int | None" = None,
                  max_dumps: "int | None" = None) -> "FlightRecorder":
        """Mutate IN PLACE (call sites cache the singleton). Only the
        arguments given change; ``capacity`` rebuilds the ring keeping
        the newest spans."""
        if capacity is not None and capacity != self._ring.maxlen:
            self._ring = collections.deque(self._ring,
                                           maxlen=int(capacity))
        if dump_dir is not None:
            self.dump_dir = dump_dir
        if max_dumps is not None:
            self.max_dumps = int(max_dumps)
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    # ---- record side -----------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)          # hot path: one dict read
        if tid is None:
            with self._tid_lock:             # len+insert must be atomic:
                tid = self._tids.get(ident)  # two first-span threads
                if tid is None:              # racing would share a tid
                    tid = len(self._tids) + 1
                    self._tids[ident] = tid
        return tid

    def span(self, name: str, wave: "int | None" = None,
             **args):
        """Context manager recording one span — or the shared no-op when
        disabled (zero allocation on the off path beyond the call)."""
        if not self.enabled:
            return NOOP
        return _SpanCtx(self, name, wave, args or None)

    def add(self, name: str, t0: float, t1: float,
            wave: "int | None" = None, **args) -> None:
        """Record a completed span from explicit ``time.monotonic``
        timestamps (the pipeline's wave legs carry their own)."""
        if not self.enabled:
            return
        self._ring.append(Span(name, t0, t1, self._tid(), wave,
                               args or None))

    def instant(self, name: str, wave: "int | None" = None,
                **args) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        self._ring.append(_Instant(name, now, now, self._tid(), wave,
                                   args or None))

    # ---- read side -------------------------------------------------------

    def snapshot(self) -> "list[Span]":
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def to_chrome(self, reason: "str | None" = None,
                  failing: "str | None" = None) -> dict:
        """The ring as a Chrome-trace-event document. Extra top-level
        keys (``reason`` / ``failing_span``) are legal — viewers read
        ``traceEvents`` and ignore the rest — and make the post-mortem
        self-describing without opening a viewer."""
        events = [s.to_event() for s in self.snapshot()]
        if reason is not None:
            now = time.monotonic()
            mark = _Instant(f"FAULT:{reason}", now, now, self._tid(),
                            None, {"failing_span": failing or ""})
            events.append(mark.to_event())
        doc: dict[str, Any] = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
            # clock anchor: span timestamps are per-process
            # ``time.monotonic``; one (monotonic, wall) pair taken at
            # dump time puts dumps of several processes on one axis
            "clock_sync": {"monotonic_us": round(time.monotonic() * 1e6,
                                                 1),
                           "unix_us": round(time.time() * 1e6, 1),
                           "pid": os.getpid()},
        }
        if reason is not None:
            doc["reason"] = reason
        if failing is not None:
            doc["failing_span"] = failing
        return doc

    def dump(self, path: "str | None" = None, reason: str = "manual",
             failing: "str | None" = None) -> "str | None":
        """Write the ring as Chrome trace JSON. ``path=None`` names the
        file ``flight_{seq:03d}_{reason}.json`` under ``dump_dir``
        (None returned when no dir is configured)."""
        with self._dump_lock:
            return self._dump_locked(path, reason, failing)

    def _dump_locked(self, path: "str | None", reason: str,
                     failing: "str | None") -> "str | None":
        # caller holds _dump_lock
        if path is None:
            if not self.dump_dir:
                return None
            self._dump_seq += 1
            path = os.path.join(
                self.dump_dir,
                f"flight_{self._dump_seq:03d}_{reason}.json")
        doc = self.to_chrome(reason=reason, failing=failing)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)         # a reader never sees a torn dump
        self.dumps_written += 1
        return path

    def post_mortem(self, reason: str, failing: "str | None" = None,
                    **args) -> "str | None":
        """The fault-site hook: record the fault as an instant event and
        dump the ring, bounded by ``max_dumps`` per process (a flapping
        link must not fill the disk with identical post-mortems — the
        suppressed count keeps the overflow visible). No-op unless
        tracing is enabled AND a dump dir is configured."""
        if not self.enabled or not self.dump_dir:
            return None
        self.instant(f"FAULT:{reason}", **dict(args,
                                               failing_span=failing or ""))
        # check-and-write under ONE _dump_lock acquisition: a separate
        # check section let two racing fault sites both pass at
        # max_dumps-1 and write past the bound
        with self._dump_lock:
            if self.dumps_written >= self.max_dumps:
                self.dumps_suppressed += 1
                return None
            try:
                return self._dump_locked(None, reason, failing)
            except OSError:           # ENOSPC etc: a post-mortem must
                return None           # never take the worker down with it


# ---------------------------------------------------------------------------
# Process-global recorder (env-configured once, like faults.active())

_ENV_ON = "RTPU_TRACE"
_ENV_DIR = "RTPU_TRACE_DIR"
_ENV_RING = "RTPU_TRACE_RING"


def env_flag(value: "str | None", strict: bool = False) -> bool:
    """THE env-var truthiness parse for RTPU_*/REPORTER_* boolean knobs
    (``config.env_flag`` re-exports it), so the config view and the
    process-global recorder never disagree on one string. Unset,
    blank/whitespace, and 0/false/off/no are False.

    ``strict=True`` raises ValueError on a token outside the recognized
    true/false sets instead of reading it as True: a mistyped kernel
    lever must fail loudly, or an A/B run measures an arm against
    itself."""
    if not value:
        return False
    tok = value.strip().lower()
    if strict and tok not in ("", "0", "false", "off", "no",
                              "1", "true", "on", "yes"):
        raise ValueError(f"unrecognized boolean env value {value!r}; "
                         "use 0/1 (or true/false, on/off, yes/no)")
    return tok not in ("", "0", "false", "off", "no")


_tracer = FlightRecorder()
_env_lock = locks.named_lock("tracer.env")
_env_applied = False


def tracer() -> FlightRecorder:
    """THE recorder every call site shares. Env enablement is applied
    once, lazily — a spawned worker inherits RTPU_TRACE* and records
    the same way its parent did (the RTPU_FAULTS discipline)."""
    global _env_applied
    if not _env_applied:
        with _env_lock:
            if not _env_applied:
                if env_flag(os.environ.get(_ENV_ON)):
                    _tracer.configure(enabled=True)
                d = os.environ.get(_ENV_DIR, "")
                if d:
                    _tracer.configure(dump_dir=d)
                ring = os.environ.get(_ENV_RING, "")
                if ring:
                    _tracer.configure(capacity=int(ring))
                _env_applied = True
    return _tracer


def configure(**kw) -> FlightRecorder:
    return tracer().configure(**kw)


def configure_from_service(svc) -> None:
    """ServiceConfig → recorder, applied at app/pipeline construction.
    Only ever turns tracing ON, and only applies ring/dir knobs set
    AWAY from their defaults — a second component constructed with the
    defaults must never degrade an env-configured recorder (e.g.
    RTPU_TRACE_RING=65536 trimmed back to 4096, discarding 15/16ths of
    the flight history, by an app whose config left trace_ring alone)."""
    if getattr(svc, "trace", False):
        import dataclasses

        defaults = ({f.name: f.default for f in dataclasses.fields(svc)}
                    if dataclasses.is_dataclass(svc) else {})
        tr = tracer()
        tr.configure(enabled=True)
        ring = int(getattr(svc, "trace_ring", 4096))
        if ring != defaults.get("trace_ring", 4096):
            tr.configure(capacity=ring)
        d = getattr(svc, "trace_dir", "")
        if d:
            tr.configure(dump_dir=d)


def span(name: str, wave: "int | None" = None, **args):
    return tracer().span(name, wave=wave, **args)


def post_mortem(reason: str, failing: "str | None" = None,
                **args) -> "str | None":
    return tracer().post_mortem(reason, failing=failing, **args)
