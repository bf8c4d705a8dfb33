"""Link-health telemetry: the state of the host–card path behind every
number.

Counterpart: reporter_tpu/utils/linkhealth.py, with its names, its
environment variables and defaults, its mood levels and its gauges.

  LinkHealthSampler   a daemon thread probing the round-trip time and the
                      host-to-card copy rate at low duty (one probe per
                      ``RTPU_LINK_PROBE_PERIOD_S``, 90 s by default; the
                      recorded ``probe_duty_pct`` keeps the cost
                      measured), each probe bounded by the shared
                      watchdog (utils/watchdog.py), and classifying the
                      link's mood:

                        healthy    round trip and rate inside thresholds
                        degraded   slow but alive (round trip above
                                   ``degraded_rtt_s`` or rate below
                                   ``degraded_mbps``)
                        dead       a probe timed out or raised, or the
                                   dispatch watchdog reported a timeout
                        cpu        the serving device is the CPU: no
                                   host–card path in play

  window(since)       the summary of [since, now]: the median round trip
                      and rate and the WORST mood seen (a run that
                      straddled a dead spell says so even if the link
                      recovered before it ended).

The probe (``_device_probe``) times, on a stream of its own, one small
round trip (a one-element kernel and its copy back to pinned host
memory, then that stream's synchronize) by the host clock, and one copy
of a pinned host buffer of ``RTPU_LINK_PROBE_BYTES`` (256 KiB) to the
card between two CUDA events. On a CPU device it returns (None, None)
and the mood is "cpu"; a probe that fails is "dead" with no reading,
never a CPU reading.

Mood surfaces where the other observability lives: gauges
(``link_rtt_ms``, ``link_mbps``, ``link_mood``, ``link_probes``,
``link_dead_probes`` → ``rtpu_link_*`` at /metrics) in every attached
MetricsRegistry; a dead-link detection (a transition into "dead" by a
probe) records a tracer instant and one flight-recorder post-mortem;
the matcher's dispatch watchdog feeds its timeouts back through
``note_dispatch_timeout()`` (its own site already dumps, so the note only
records the sample).

The state lock guards the ring and the attached registries; probes run
outside it always (a stalled copy must never wedge readers). One
process-global sampler (``sampler()``, ``ensure_serving()``): every
ReporterApp and streaming worker in the process shares one probe thread
and one mood. ``RTPU_LINK_PROBE=0`` disables it.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import weakref
from typing import Callable

from reporter_tpu_torch.utils import locks, tracing
from reporter_tpu_torch.utils.watchdog import TIMED_OUT, AbandonedThreadWatchdog

__all__ = [
    "LinkSample", "LinkHealthSampler", "sampler", "ensure_serving",
    "note_dispatch_timeout", "configure", "enabled", "MOOD_LEVELS",
]

# mood → numeric gauge level (rtpu_link_mood); the window reports the
# most severe mood seen, so one dead probe in a long run reads dead
MOOD_LEVELS = {"healthy": 0, "degraded": 1, "dead": 2, "cpu": 3}
_SEVERITY = {"healthy": 0, "cpu": 0, "degraded": 1, "dead": 2}

_ENV_PROBE = "RTPU_LINK_PROBE"
_ENV_PERIOD = "RTPU_LINK_PROBE_PERIOD_S"
_ENV_BYTES = "RTPU_LINK_PROBE_BYTES"
_ENV_DEGRADED_RTT = "RTPU_LINK_DEGRADED_RTT_MS"
_ENV_DEGRADED_MBPS = "RTPU_LINK_DEGRADED_MBPS"
_ENV_DEAD = "RTPU_LINK_DEAD_S"


class LinkSample:
    """One probe (or externally reported) observation."""

    __slots__ = ("t", "rtt_s", "mbps", "mood", "source")

    def __init__(self, t: float, rtt_s: "float | None",
                 mbps: "float | None", mood: str, source: str = "probe"):
        self.t = t
        self.rtt_s = rtt_s
        self.mbps = mbps
        self.mood = mood
        self.source = source

    def to_json(self) -> dict:
        return {"t": round(self.t, 3),
                "rtt_ms": (None if self.rtt_s is None
                           else round(self.rtt_s * 1e3, 2)),
                "mbps": (None if self.mbps is None
                         else round(self.mbps, 2)),
                "mood": self.mood, "source": self.source}


class _ProbeBuffers:
    """The probe's stream and buffers on one card, allocated once."""

    def __init__(self, device, nbytes: int):
        import torch

        self.stream = torch.cuda.Stream(device)
        self.tiny = torch.zeros(1, dtype=torch.float32, device=device)
        self.tiny_host = torch.empty(1, dtype=torch.float32).pin_memory()
        self.host = torch.zeros(nbytes, dtype=torch.uint8).pin_memory()
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        torch.cuda.synchronize(device)   # allocated on the default stream
        self.warmed = False


_buffers: "dict[tuple, _ProbeBuffers]" = {}
_buffers_lock = locks.named_lock("linkhealth.buffers")


def _device_probe(nbytes: int, device) -> "tuple[float | None, float | None]":
    """(rtt_s, mbps) on ``device``: one small round trip (a one-element
    kernel and its copy back to pinned host memory, on the probe's own
    stream, by the host clock) and one pinned host-to-card copy of
    ``nbytes`` between two CUDA events. (None, None) on a CPU device: no
    host–card path, the caller records mood "cpu". The first call on a
    card allocates the buffers and warms the round trip and the copy,
    untimed. May
    stall; the sampler bounds it with the watchdog and never calls it
    under a lock."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return None, None
    nbytes = max(int(nbytes), 1024)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), nbytes)
    with _buffers_lock:
        buf = _buffers.get(key)
        if buf is None:
            buf = _buffers[key] = _ProbeBuffers(torch.device("cuda", key[0]),
                                                nbytes)
    # the probe's card current: its events and copies are that card's
    with torch.cuda.device(key[0]), torch.cuda.stream(buf.stream):
        if not buf.warmed:      # the first round trip and copy, untimed
            buf.tiny_host.copy_(buf.tiny + 1, non_blocking=True)
            buf.dev.copy_(buf.host, non_blocking=True)
            buf.stream.synchronize()
            buf.warmed = True
        t0 = time.perf_counter()
        buf.tiny_host.copy_(buf.tiny + 1, non_blocking=True)
        buf.stream.synchronize()
        rtt = time.perf_counter() - t0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(buf.stream)
        buf.dev.copy_(buf.host, non_blocking=True)
        e1.record(buf.stream)
        e1.synchronize()
        ms = max(e0.elapsed_time(e1), 1e-6)
    return rtt, nbytes / (ms / 1e3) / 1e6


class LinkHealthSampler:
    """Bounded ring of link observations, and the probe thread.

    ``device``: the card to probe (a CPU device reports mood "cpu"); None
    probes the card when one is present (``torch.cuda.is_available()``),
    else reports "cpu". ``probe(nbytes) → (rtt_s, mbps)`` replaces the
    device probe (tests inject one)."""

    def __init__(self,
                 probe: "Callable[[int], tuple] | None" = None,
                 period_s: "float | None" = None,
                 probe_bytes: "int | None" = None,
                 ring: int = 512,
                 degraded_rtt_s: "float | None" = None,
                 degraded_mbps: "float | None" = None,
                 dead_timeout_s: "float | None" = None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        e = os.environ
        self.device = device
        self.probe = (probe if probe is not None
                      else lambda n: _device_probe(n, self.probe_device()))
        self.period_s = float(period_s if period_s is not None
                              else e.get(_ENV_PERIOD, "90"))
        self.probe_bytes = int(probe_bytes if probe_bytes is not None
                               else e.get(_ENV_BYTES, str(256 * 1024)))
        self.degraded_rtt_s = float(
            degraded_rtt_s if degraded_rtt_s is not None
            else float(e.get(_ENV_DEGRADED_RTT, "400")) / 1e3)
        self.degraded_mbps = float(degraded_mbps if degraded_mbps is not None
                                   else e.get(_ENV_DEGRADED_MBPS, "5"))
        self.dead_timeout_s = float(dead_timeout_s
                                    if dead_timeout_s is not None
                                    else e.get(_ENV_DEAD, "10"))
        self.clock = clock
        self._lock = locks.named_lock("linkhealth.state")
        self._ring: "collections.deque[LinkSample]" = collections.deque(
            maxlen=int(ring))
        self._registries: "list[weakref.ref]" = []
        self._watchdog = AbandonedThreadWatchdog(
            cap=4, thread_name="linkhealth-probe")
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.probe_seconds_total = 0.0
        self.probes_total = 0
        self.dead_probes_total = 0
        self._started_at: "float | None" = None

    def probe_device(self):
        """The device the default probe reads (see the class doc)."""
        import torch

        if self.device is not None:
            return torch.device(self.device)
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "LinkHealthSampler":
        """Idempotent; the thread probes once at once, then every
        ``period_s``."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = threading.Event()
            self._started_at = self.clock()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="linkhealth-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:       # noqa: BLE001 - a recorder bug skips
                pass                # the tick, never kills the thread
            self._stop.wait(self.period_s)

    # ---- probing ---------------------------------------------------------

    def sample_once(self) -> LinkSample:
        """One bounded probe → classify → record. Never called under the
        state lock: the probe may stall."""
        if self._watchdog.tripped:
            # breaker open: ``cap`` probes are still stuck; record dead
            # without pinning one more thread and buffer per period (a
            # stuck probe that lands un-counts itself, and probing resumes)
            sample = LinkSample(self.clock(), None, None, "dead",
                                source="probe_breaker_open")
            self._record(sample)
            return sample
        t0 = time.perf_counter()
        try:
            out = self._watchdog.run(lambda: self.probe(self.probe_bytes),
                                     timeout=self.dead_timeout_s)
        except Exception as exc:    # noqa: BLE001 - a raising probe is a
            out = TIMED_OUT         # dead observation, not a crash
            src = f"probe_error:{type(exc).__name__}"
        else:
            src = "probe_timeout"
        dt = time.perf_counter() - t0
        if out is TIMED_OUT:
            sample = LinkSample(self.clock(), None, None, "dead",
                                source=src)
        else:
            try:
                rtt_s, mbps = out
            except Exception:       # noqa: BLE001
                rtt_s = mbps = None
            sample = LinkSample(self.clock(), rtt_s, mbps,
                                self._classify(rtt_s, mbps))
        self._record(sample, probe_seconds=dt)
        return sample

    def _classify(self, rtt_s: "float | None",
                  mbps: "float | None") -> str:
        if rtt_s is None and mbps is None:
            return "cpu"
        if rtt_s is not None and rtt_s > self.degraded_rtt_s:
            return "degraded"
        if mbps is not None and mbps < self.degraded_mbps:
            return "degraded"
        return "healthy"

    def note_dispatch_timeout(self, reason: str = "dispatch_timeout",
                              **args) -> None:
        """External dead-link signal: the matcher's dispatch watchdog saw
        a stall the probe thread may be minutes from noticing. The
        reporting site already dumps a post-mortem, so this records the
        sample and the gauges only."""
        self._record(LinkSample(self.clock(), None, None, "dead",
                                source=reason), post_mortem=False)

    def _record(self, sample: LinkSample, probe_seconds: float = 0.0,
                post_mortem: bool = True) -> None:
        with self._lock:
            prev = self._ring[-1].mood if self._ring else None
            self._ring.append(sample)
            self.probes_total += 1
            self.probe_seconds_total += probe_seconds
            if sample.mood == "dead":
                self.dead_probes_total += 1
            self._publish_locked(sample)
        if sample.mood == "dead" and post_mortem:
            # one dump per detection (a transition into dead), not per
            # dead sample: a flapping link must not spend the dump budget
            tr = tracing.tracer()
            tr.instant("link_dead", source=sample.source)
            if prev != "dead":
                tr.post_mortem("link_dead", failing="link_probe",
                               source=sample.source)

    # ---- gauges ----------------------------------------------------------

    def attach(self, registry) -> None:
        """Publish ``link_*`` gauges into ``registry`` on every sample
        from now on (held weakly); the latest sample, if any, at once."""
        with self._lock:
            if not any(r() is registry for r in self._registries):
                self._registries.append(weakref.ref(registry))
            last = self._ring[-1] if self._ring else None
            if last is not None:
                self._publish_locked(last)

    def _publish_locked(self, sample: LinkSample) -> None:
        alive = []
        for ref in self._registries:
            reg = ref()
            if reg is None:
                continue
            alive.append(ref)
            if sample.rtt_s is not None:
                reg.gauge("link_rtt_ms", sample.rtt_s * 1e3)
            if sample.mbps is not None:
                reg.gauge("link_mbps", sample.mbps)
            reg.gauge("link_mood", MOOD_LEVELS[sample.mood])
            reg.gauge("link_dead_probes", self.dead_probes_total)
            reg.gauge("link_probes", self.probes_total)
        self._registries[:] = alive

    # ---- read side -------------------------------------------------------

    def latest(self) -> "LinkSample | None":
        with self._lock:
            return self._ring[-1] if self._ring else None

    def samples(self) -> "list[LinkSample]":
        with self._lock:
            return list(self._ring)

    def probe_duty_pct(self) -> "float | None":
        """Probe seconds over the sampler's lifetime, in percent."""
        with self._lock:
            if self._started_at is None:
                return None
            up = max(self.clock() - self._started_at, 1e-6)
            return round(100.0 * self.probe_seconds_total / up, 4)

    def window(self, since: "float | None" = None) -> dict:
        """The link over [since, now]: median round trip and rate and the
        worst mood (dead > degraded > healthy / cpu). An empty window
        falls back to the latest sample, and mood None means nothing was
        ever sampled."""
        with self._lock:
            xs = [s for s in self._ring
                  if since is None or s.t >= since]
            if not xs and self._ring:
                xs = [self._ring[-1]]
        if not xs:
            return {"rtt_ms": None, "mbps": None, "mood": None,
                    "samples": 0}
        rtts = sorted(s.rtt_s for s in xs if s.rtt_s is not None)
        bws = sorted(s.mbps for s in xs if s.mbps is not None)
        mood = max(xs, key=lambda s: _SEVERITY[s.mood]).mood
        return {
            "rtt_ms": (None if not rtts
                       else round(rtts[len(rtts) // 2] * 1e3, 2)),
            "mbps": (None if not bws
                     else round(bws[len(bws) // 2], 2)),
            "mood": mood,
            "samples": len(xs),
        }


# ---------------------------------------------------------------------------
# The process-global sampler: every app and worker of a process shares one
# probe thread and one recorded mood.

_global: "LinkHealthSampler | None" = None
_global_lock = locks.named_lock("linkhealth.registry")


def sampler() -> LinkHealthSampler:
    """The process sampler (built lazily from the environment, not
    started: ``ensure_serving`` starts it)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = LinkHealthSampler()
        return _global


def configure(s: "LinkHealthSampler | None") -> None:
    """Swap the process sampler (tests install one with a fake probe;
    None resets to lazy construction)."""
    global _global
    with _global_lock:
        _global = s


def enabled() -> bool:
    """The ``RTPU_LINK_PROBE`` gate, on by default; a token that is not a
    boolean raises."""
    raw = os.environ.get(_ENV_PROBE)
    if raw is None or not raw.strip():
        return True
    return tracing.env_flag(raw, strict=True)


def ensure_serving(registry, device=None) -> "LinkHealthSampler | None":
    """The serving face's hook (ReporterApp, the streaming worker):
    attach ``registry`` to the process sampler and start its probe
    thread, if the gate allows. ``device`` is the serving device: a card
    becomes the sampler's probe target (a CPU device only where none was
    named yet, so a process serving on both probes the card). → the
    sampler, None when disabled."""
    if not enabled():
        return None
    s = sampler()
    if device is not None:
        import torch

        dev = torch.device(device)
        with _global_lock:
            if s.device is None or (dev.type == "cuda"
                                    and torch.device(s.device).type == "cpu"):
                s.device = dev
    s.attach(registry)
    s.start()
    return s


def note_dispatch_timeout(reason: str = "dispatch_timeout",
                          **args) -> None:
    """Module-level dead-link signal for sites without a sampler (the
    matcher's dispatch watchdog); a no-op when no sampler was built."""
    with _global_lock:
        s = _global
    if s is not None:
        s.note_dispatch_timeout(reason, **args)
