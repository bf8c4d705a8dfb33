"""Per-stage wall-clock metrics and counters.

Counterpart: reporter_tpu/utils/metrics.py (``labeled``,
``MetricsRegistry``: ``count``, ``gauge``, ``observe``, ``stage``,
``value``, ``snapshot``, ``render_prometheus``), with the same series
names and the same ``rtpu_`` exposition prefix, so a dashboard reads
either package's ``/stats`` and ``/metrics``. A registry of named
counters, gauges and observation series with bounded reservoir
percentiles and fixed-bucket histograms; every write is O(1) and
lock-guarded (the service's handler and batch threads all write it).
The cross-worker ``export`` / merge forms wait for the streaming and
topology front-ends.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Any

from reporter_tpu_torch.utils import locks

# Fixed histogram bucket upper bounds (seconds-scale, matching the
# stage-timer series this registry mostly holds). FIXED, not adaptive:
# Prometheus histogram_quantile aggregates across workers only when every
# exposition shares the same ``le`` grid, and a capture's buckets must
# mean the same thing run over run. Dimensionless series (occupancies,
# ratios) land in the low buckets — still monotone, still aggregable.
HISTOGRAM_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_VALUE = re.compile(r"[\"\\\n]")

def labeled(name: str, **labels) -> str:
    """Canonical label-suffixed series key: ``labeled("fleet_hits",
    metro="sf")`` → ``fleet_hits{metro="sf"}``. THE spelling for
    per-metro (and any future per-partition/per-worker) series — the
    registry stores the full string as the key, snapshot() reports it
    verbatim, and render_prometheus() splits it back into a metric name
    plus a real Prometheus label block (grouped under one # TYPE line
    per base name). Label order is sorted so the same logical series
    can never fork into two keys."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_LABEL_VALUE.sub("_", str(v))}"'
        for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _split_labels(key: str) -> tuple[str, str]:
    """``name{a="b"}`` → (``name``, ``{a="b"}``); plain names pass
    through with an empty label block."""
    if key.endswith("}") and "{" in key:
        base, _, rest = key.partition("{")
        return base, "{" + rest
    return key, ""


def _with_suffix(key: str, suffix: str) -> str:
    """Append a derived-series suffix BEFORE any label block, so
    ``fleet_promote_seconds{metro="a"}`` derives
    ``fleet_promote_seconds_total{metro="a"}`` (a valid labeled series)
    rather than a name with trailing braces in the middle."""
    base, lab = _split_labels(key)
    return base + suffix + lab


class _Reservoir:
    """Bounded sample ring for percentile estimates (newest-N policy —
    streaming metrics should reflect recent behavior, not all of history)."""

    __slots__ = ("_buf", "_cap", "_n")

    def __init__(self, cap: int = 1024):
        self._buf: list[float] = []
        self._cap = cap
        self._n = 0

    def add(self, v: float) -> None:
        if len(self._buf) < self._cap:
            self._buf.append(v)
        else:
            self._buf[self._n % self._cap] = v
        self._n += 1


def _pick(sorted_buf: "list[float]", q: float) -> float:
    i = min(len(sorted_buf) - 1,
            max(0, int(q * (len(sorted_buf) - 1) + 0.5)))
    return sorted_buf[i]


class StageTimer:
    """Context manager that records one stage's wall time:

        with metrics.stage("decode"):
            ...
    """

    __slots__ = ("_registry", "_name", "_t0")

    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        # _with_suffix, not concatenation: a labeled stage name
        # (stage(labeled("x", metro="sf"))) must derive
        # x_seconds{metro="sf"}, not a key with braces mid-name
        self._registry.observe(_with_suffix(self._name, "_seconds"),
                               time.perf_counter() - self._t0)


class MetricsRegistry:
    """Named counters + observation series; thread-safe; snapshot-able."""

    def __init__(self):
        self._lock = locks.named_lock("metrics.registry")
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._series: dict[str, _Reservoir] = {}
        # per-series fixed-bucket cumulative counts (len(BUCKETS)+1, the
        # last slot is +Inf) for the Prometheus histogram exposition —
        # reservoirs forget history by design, histograms must not
        self._hist: dict[str, list[int]] = {}
        self._born = time.time()

    # ---- write side ------------------------------------------------------

    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time level (lag, in-flight waves, queue depth) —
        last write wins, snapshot reports it verbatim. Counters accumulate
        events; gauges answer "how deep is the backlog RIGHT NOW", which
        is what streaming overload monitoring alerts on."""
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            r = self._series.get(name)
            if r is None:
                r = self._series[name] = _Reservoir()
                self._hist[name] = [0] * (len(HISTOGRAM_BUCKETS) + 1)
            r.add(value)
            self._hist[name][bisect.bisect_left(HISTOGRAM_BUCKETS,
                                                value)] += 1
            total = _with_suffix(name, "_total")
            count = _with_suffix(name, "_count")
            self._counters[total] = self._counters.get(total, 0.0) + value
            self._counters[count] = self._counters.get(count, 0.0) + 1

    def stage(self, name: str) -> StageTimer:
        return StageTimer(self, name)

    # ---- read side -------------------------------------------------------

    def value(self, name: str) -> float:
        """Counter value, falling back to the gauge of the same name
        (scheduler tests/operators read point-in-time levels like
        sched_inflight_batches through the same accessor)."""
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, 0.0)

    def snapshot(self) -> dict[str, Any]:
        """Plain-dict view: counters + gauges verbatim + p50/p95/p99 per
        series + derived rates for the north-star metrics when their
        inputs exist. The sample buffers are COPIED out under the lock
        and sorted outside it — a snapshot with many fat series must not
        stall every concurrent count()/observe() on its O(n log n)."""
        with self._lock:
            out: dict[str, Any] = dict(self._counters)
            out.update(self._gauges)
            bufs = {name: list(r._buf) for name, r in self._series.items()}
        for name, buf in bufs.items():
            if buf:
                buf.sort()
                out[_with_suffix(name, "_p50")] = _pick(buf, 0.50)
                out[_with_suffix(name, "_p95")] = _pick(buf, 0.95)
                out[_with_suffix(name, "_p99")] = _pick(buf, 0.99)
            else:
                nan = float("nan")
                out[_with_suffix(name, "_p50")] = nan
                out[_with_suffix(name, "_p95")] = nan
                out[_with_suffix(name, "_p99")] = nan
        probes = out.get("probes", 0.0)
        busy = out.get("match_seconds_total", 0.0)
        if probes and busy:
            out["probes_per_sec_busy"] = probes / busy
        out["uptime_seconds"] = time.time() - self._born
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the whole
        registry: counters and gauges verbatim, each observation series
        as a histogram over the FIXED ``HISTOGRAM_BUCKETS`` grid (the
        reservoir percentiles stay a /stats affordance; scrapers get
        aggregable cumulative buckets). Names are prefixed ``rtpu_`` and
        sanitized to the exposition charset."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {name: (list(h),
                            self._counters.get(
                                _with_suffix(name, "_total"), 0.0),
                            int(self._counters.get(
                                _with_suffix(name, "_count"), 0.0)))
                     for name, h in self._hist.items()}
        lines: list[str] = []

        def _name(raw: str) -> str:
            return "rtpu_" + _PROM_NAME.sub("_", raw)

        def _grouped(items: dict) -> dict:
            """base name → [(label block, value)], insertion-sorted:
            labeled series (the per-metro fleet counters/gauges) share
            ONE ``# TYPE`` line per base, as the exposition format
            requires — a TYPE line per labeled sample would be a
            duplicate-metadata parse error for strict scrapers."""
            groups: dict[str, list] = {}
            for key, value in sorted(items.items()):
                base, lab = _split_labels(key)
                groups.setdefault(base, []).append((lab, value))
            return groups

        # series aggregates re-emit as the histogram's _sum/_count below
        shadow = {_with_suffix(k, suffix) for k in hists for suffix in
                  ("_total", "_count")}
        for base, samples in _grouped({k: v for k, v in counters.items()
                                       if k not in shadow}).items():
            n = _name(base)
            lines.append(f"# TYPE {n} counter")
            for lab, value in samples:
                lines.append(f"{n}{lab} {float(value)}")
        gauges["uptime_seconds"] = time.time() - self._born
        for base, samples in _grouped(gauges).items():
            n = _name(base)
            lines.append(f"# TYPE {n} gauge")
            for lab, value in samples:
                lines.append(f"{n}{lab} {float(value)}")
        for base, series in _grouped(hists).items():
            n = _name(base)
            lines.append(f"# TYPE {n} histogram")
            for lab, (buckets, total, count) in series:
                # merge ``le`` into any existing label block: a labeled
                # histogram's buckets are {metro="a",le="0.5"}, one series
                inner = lab[1:-1] + "," if lab else ""
                cum = 0
                for le, c in zip(HISTOGRAM_BUCKETS, buckets):
                    cum += c
                    lines.append(f'{n}_bucket{{{inner}le="{le}"}} {cum}')
                cum += buckets[-1]
                lines.append(f'{n}_bucket{{{inner}le="+Inf"}} {cum}')
                lines.append(f"{n}_sum{lab} {float(total)}")
                lines.append(f"{n}_count{lab} {count}")
        return "\n".join(lines) + "\n"
