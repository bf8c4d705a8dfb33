"""Per-stage wall-clock metrics and counters.

Counterpart: reporter_tpu/utils/metrics.py (``labeled``,
``MetricsRegistry``: ``count``, ``gauge``, ``observe``, ``stage``,
``value``, ``snapshot``, ``export``, ``render_prometheus``;
``with_labels``, ``delta_exports``, ``delta_since``, ``SnapshotRing``,
``merge_exports``), with the same series names, the same ``rtpu_``
exposition prefix and the same export documents, so a dashboard reads
either package's ``/stats`` and ``/metrics``, and a supervisor merges
either package's exports. A registry of named counters, gauges and
observation series with bounded reservoir percentiles and fixed-bucket
histograms; every write is O(1) and lock-guarded (the service's handler
and batch threads all write it).
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

# version tag on MetricsRegistry.export() documents (the snapshot files
# the topology supervisor tails): bumped when the merge semantics change
EXPORT_SCHEMA = 1


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


_LABEL_PAIR = re.compile(r'(\w+)="([^"]*)"')


def with_labels(key: str, **extra) -> str:
    """Add labels to a series key that may ALREADY carry a label block:
    ``with_labels('stream_lag{metro="sf"}', worker="w0")`` →
    ``stream_lag{metro="sf",worker="w0"}``. Existing labels win on a
    name clash (a member's own label is its identity; an aggregator
    must never overwrite it). Routed through ``labeled()`` so the
    sorted-label canonical spelling holds here too."""
    base, lab = _split_labels(key)
    labels = dict(_LABEL_PAIR.findall(lab))
    for k, v in extra.items():
        labels.setdefault(k, v)
    return labeled(base, **labels)


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
                # setdefault, not assignment: a merged registry
                # (merge_exports) carries histograms with no reservoir
                # behind them; a later observe() into the same name
                # extends those bucket counts, never zeroes them
                self._hist.setdefault(
                    name, [0] * (len(HISTOGRAM_BUCKETS) + 1))
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

    def export(self) -> dict:
        """The MERGE-ABLE wire form of the whole registry (cross-worker
        aggregation, the reason ``HISTOGRAM_BUCKETS`` is fixed): counters and gauges verbatim plus
        every observation series' fixed-bucket counts. Reservoir SAMPLES
        are deliberately absent — percentiles are a process-local
        affordance (/stats), the aggregable artifact is the histogram,
        so merged expositions DROP ``_p50/_p99`` rather than publish a
        quantile no math can justify (test-pinned)."""
        with self._lock:
            return {
                "schema": EXPORT_SCHEMA,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "hist": {k: list(v) for k, v in self._hist.items()},
            }

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


def delta_exports(newer: dict, older: dict) -> dict:
    """Element-wise ``newer − older`` over two ``export()`` documents —
    the windowed-rate primitive the SLO plane (obs/slo.py) burns on.

    Counters and histogram buckets diff (clamped at 0: a restarted
    worker's reset must read as "no progress", never as negative burn);
    gauges carry ``newer``'s values verbatim (a level has no meaningful
    difference over a window — the SLO engine samples gauges into
    synthetic counters instead). The result carries the ``schema`` tag
    so it IS a valid export: ``merge_exports`` accepts delta documents,
    which is what makes topology-wide burn well-defined — on counters
    and buckets the diff is linear, so delta-of-merged-exports equals
    merge-of-per-worker-deltas exactly (property-tested,
    tests/test_slo.py and tests/test_torch_slo.py)."""
    old_counters = older.get("counters") or {}
    counters = {
        k: max(0.0, float(v) - float(old_counters.get(k, 0.0)))
        for k, v in (newer.get("counters") or {}).items()}
    old_hist = older.get("hist") or {}
    hist = {}
    for k, buckets in (newer.get("hist") or {}).items():
        prev = list(old_hist.get(k) or ())
        prev += [0] * (len(buckets) - len(prev))
        hist[k] = [max(0, int(b) - int(p))
                   for b, p in zip(buckets, prev)]
    return {"schema": EXPORT_SCHEMA, "counters": counters,
            "gauges": dict(newer.get("gauges") or {}), "hist": hist}


def delta_since(snapshots, window_s: float, now: "float | None" = None):
    """Windowed diff over a chronological ``[(monotonic_t, export), …]``
    sequence: returns ``(delta_exports(newest, baseline), span_s)``
    where the baseline is the LATEST snapshot at or before
    ``now − window_s`` (fallback: the oldest held — a young ring yields
    a shorter, honestly-reported span rather than a fabricated one).
    With fewer than two snapshots the delta is all-zero and the span 0.0
    — a first tick can never alert."""
    if not snapshots:
        return None, 0.0
    t_new, newest = snapshots[-1]
    if now is None:
        now = t_new
    cutoff = now - window_s
    base_t, base = snapshots[0]
    for t, exp in snapshots:
        if t <= cutoff:
            base_t, base = t, exp
        else:
            break
    return delta_exports(newest, base), max(0.0, t_new - base_t)


class SnapshotRing:
    """Bounded chronological ring of (monotonic_t, export) snapshots —
    the state behind ``delta_since``. Unlocked by design: the one
    writer/reader is the SLO evaluator's tick, which holds its own named
    lock."""

    __slots__ = ("_snaps", "_cap")

    def __init__(self, cap: int = 512):
        self._snaps: list = []
        self._cap = cap

    def push(self, t: float, export: dict) -> None:
        self._snaps.append((float(t), export))
        if len(self._snaps) > self._cap:
            del self._snaps[0]

    def __len__(self) -> int:
        return len(self._snaps)

    def delta_since(self, window_s: float, now: "float | None" = None):
        return delta_since(self._snaps, window_s, now)


def merge_exports(exports: "dict[str, dict]") -> MetricsRegistry:
    """K member ``export()`` documents → ONE fleet-wide registry (the
    supervisor's merged view): keyed by member name so gauges
    stay attributable.

      counters    sum — labeled series union per full ``{metro=…}`` key
                  (identical keys from two members are the same logical
                  series and add; the ``_total``/``_count`` shadows ride
                  along, keeping histogram ``_sum``/``_count`` exact);
      gauges      carry a ``worker`` label — two members' backlog depths
                  are different facts; last-write-wins across processes
                  would fabricate a fleet-wide level nobody measured;
      histograms  sum BUCKET-WISE over the shared fixed ``le`` grid
                  (legal precisely because the grid is pinned);
      reservoirs  dropped — the merged exposition publishes no
                  ``_p50/_p99`` (see ``export()``).

    The result is a plain MetricsRegistry: ``render_prometheus()`` is
    the fleet exposition, ``snapshot()``/``value()`` serve /health math.
    Property-tested (tests/test_distributed.py, and against the JAX
    package's merge in tests/test_torch_distributed.py): merging K exports
    equals one registry observing the union of all K observation
    streams, exactly, on every counter and every bucket."""
    out = MetricsRegistry()
    with out._lock:
        for member in sorted(exports):
            exp = exports[member] or {}
            if exp.get("schema") != EXPORT_SCHEMA:
                # the tag exists to be CHECKED: an export from a
                # version-skewed process is skipped, never mis-merged
                # (empty dicts — a member with no metrics yet — carry
                # no tag and contribute nothing either way)
                continue
            for k, v in (exp.get("counters") or {}).items():
                out._counters[k] = out._counters.get(k, 0.0) + float(v)
            for k, v in (exp.get("gauges") or {}).items():
                out._gauges[with_labels(k, worker=member)] = float(v)
            for k, buckets in (exp.get("hist") or {}).items():
                h = out._hist.setdefault(
                    k, [0] * (len(HISTOGRAM_BUCKETS) + 1))
                for i, c in enumerate(buckets[:len(h)]):
                    h[i] += int(c)
    return out
