"""QualityMonitor — per-metro online quality telemetry and drift sentinel.

Counterpart: reporter_tpu/quality/monitor.py. One monitor per
SegmentMatcher: every ``match_many`` batch's
:class:`~reporter_tpu_torch.quality.signals.QualitySignals` is

  - published into the matcher's MetricsRegistry (per-metro
    ``labeled()`` counters and fixed-bucket rate histograms: ``/stats``
    and ``/metrics`` carry them);
  - folded into a bounded per-metro WINDOW of recent batches whose
    aggregate rates are compared with a per-tile BASELINE
    (:data:`BASELINES`). A window past its baseline (or an injected
    ``quality`` fault rule) fires the ``quality_drift`` fault site: a
    tracer instant and one flight-recorder post-mortem per drift
    TRANSITION.

The monitor's lock is a leaf: it guards only the window and counters;
metric publication, the fault plan and the post-mortem run outside it.
"""

from __future__ import annotations

import collections
import os

from reporter_tpu_torch import faults
from reporter_tpu_torch.quality.signals import (DEFAULT_MAX_SPEED_MPS,
                                                QualitySignals)
from reporter_tpu_torch.utils import locks, tracing
from reporter_tpu_torch.utils.metrics import labeled

__all__ = ["QualityMonitor", "BASELINES", "DEFAULT_BASELINE",
           "RATE_NAMES", "enabled"]

_ENV_GATE = "RTPU_QUALITY"
_ENV_WINDOW = "RTPU_QUALITY_WINDOW"
_ENV_TOL = "RTPU_QUALITY_DRIFT_TOL"
_ENV_MAX_SPEED = "RTPU_QUALITY_MAX_SPEED"

# the windowed quality vector, in fixed order (summary consumers
# and the baseline dicts share it)
RATE_NAMES = ("empty_match_rate", "breakage_rate", "discontinuity_rate",
              "violation_rate", "rejection_rate", "unmatched_point_rate")

# Per-tile baseline CEILINGS for the windowed rates (the JAX package's
# values): drift is "the window aggregate exceeds ceiling x
# RTPU_QUALITY_DRIFT_TOL". Gross-collapse detectors, not SLOs. Unknown
# tiles get DEFAULT.
DEFAULT_BASELINE = {
    "empty_match_rate": 0.30,
    "breakage_rate": 0.50,
    # partial mid-trace boundaries are STRUCTURAL on tiny/long-segment
    # tiles (chunked traces hand off through partial rows) — the
    # default ceiling only catches total walk collapse; per-tile
    # entries tighten where a capture pins real behavior
    "discontinuity_rate": 0.95,
    "violation_rate": 0.10,
    "rejection_rate": 0.98,
    "unmatched_point_rate": 0.50,
}
BASELINES: "dict[str, dict[str, float]]" = {
    # the measured metros, tightened where their runs pin behavior
    "sf": dict(DEFAULT_BASELINE, empty_match_rate=0.15,
               unmatched_point_rate=0.25),
    "bayarea": dict(DEFAULT_BASELINE, empty_match_rate=0.15,
                    unmatched_point_rate=0.25),
    "organic": dict(DEFAULT_BASELINE, empty_match_rate=0.20),
}


def enabled(env: "dict[str, str] | None" = None) -> bool:
    """``RTPU_QUALITY`` gate, default ON (strict parse — the config.py
    lever discipline: a typo'd gate must raise, not silently disable
    the only correctness telemetry)."""
    e = os.environ if env is None else env
    raw = e.get(_ENV_GATE)
    if raw is None or not raw.strip():
        return True
    return tracing.env_flag(raw, strict=True)


def _rates(tot: QualitySignals) -> "dict[str, float | None]":
    """Counts → rates; None where the denominator never existed."""
    def div(a, b):
        return None if not b else a / b

    return {
        "empty_match_rate": div(tot.empty_traces, tot.traces),
        "breakage_rate": div(tot.breakages, tot.pairs),
        "discontinuity_rate": div(tot.discontinuities, tot.pairs),
        "violation_rate": div(tot.speed_violations, tot.speed_checked),
        "rejection_rate": div(tot.rejected, tot.records),
        "unmatched_point_rate": (
            None if tot.unmatched_points is None
            else div(tot.unmatched_points, tot.points)),
    }


class QualityMonitor:
    """Per-metro quality window + drift sentinel (see module docstring).

    ``min_waves`` gates the BASELINE comparison only (a two-wave window
    drifting on startup noise would make the sentinel cry wolf); an
    injected ``quality`` fault rule fires regardless, so chaos coverage
    never waits for a warm window.
    """

    def __init__(self, metro: str, metrics, *,
                 window: "int | None" = None,
                 drift_tol: "float | None" = None,
                 max_speed_mps: "float | None" = None,
                 baseline: "dict[str, float] | None" = None,
                 min_waves: int = 8,
                 enabled_override: "bool | None" = None):
        e = os.environ
        self.metro = metro
        self.metrics = metrics
        self.enabled = (enabled() if enabled_override is None
                        else bool(enabled_override))
        self.window_size = int(window if window is not None
                               else e.get(_ENV_WINDOW, "32"))
        self.drift_tol = float(drift_tol if drift_tol is not None
                               else e.get(_ENV_TOL, "1.0"))
        self.max_speed_mps = float(
            max_speed_mps if max_speed_mps is not None
            else e.get(_ENV_MAX_SPEED, str(DEFAULT_MAX_SPEED_MPS)))
        self.baseline = dict(baseline if baseline is not None
                             else BASELINES.get(metro, DEFAULT_BASELINE))
        self.min_waves = int(min_waves)
        self._lock = locks.named_lock("quality.monitor")
        self._window: "collections.deque[QualitySignals]" = \
            collections.deque(maxlen=self.window_size)
        self.waves = 0
        self.drift_events = 0
        self._drifted = False
        # label keys built ONCE: labeled() sorts + regex-escapes per
        # call, and the publish path runs per BATCH — at scheduler
        # batch cadence (5 ms close) rebuilding ~19 keys per batch is
        # measurable host cost for strings that never change
        lk = {name: labeled("quality_" + name, metro=metro)
              for name in RATE_NAMES}
        self._keys = dict(lk,
                          batches=labeled("quality_batches", metro=metro),
                          traces=labeled("quality_traces", metro=metro),
                          records=labeled("quality_records", metro=metro),
                          empty=labeled("quality_empty_traces",
                                        metro=metro),
                          breakages=labeled("quality_breakages",
                                            metro=metro),
                          disc=labeled("quality_discontinuities",
                                       metro=metro),
                          viol=labeled("quality_speed_violations",
                                       metro=metro),
                          rej=labeled("quality_filter_rejected",
                                      metro=metro),
                          unmatched=labeled("quality_unmatched_points",
                                            metro=metro),
                          drift=labeled("quality_drift_total",
                                        metro=metro))

    # ---- write side ------------------------------------------------------

    def record(self, sig: QualitySignals) -> None:
        """Fold one batch's signals into the window, publish the metric
        series, and run the drift evaluation. The lock guards only the
        window/counter mutation; everything that calls out (registry,
        fault plan, tracer) runs outside it."""
        if not self.enabled:
            return
        with self._lock:
            self._window.append(sig)
            self.waves += 1
        self._publish(sig)
        self._evaluate()

    def _publish(self, sig: QualitySignals) -> None:
        m = self.metrics
        k = self._keys
        m.count(k["batches"])
        m.count(k["traces"], sig.traces)
        m.count(k["records"], sig.records)
        m.count(k["empty"], sig.empty_traces)
        m.count(k["breakages"], sig.breakages)
        m.count(k["disc"], sig.discontinuities)
        m.count(k["viol"], sig.speed_violations)
        m.count(k["rej"], sig.rejected)
        if sig.unmatched_points is not None:
            m.count(k["unmatched"], sig.unmatched_points)
        # per-batch rate observations: reservoir percentiles at /stats,
        # fixed-bucket histograms at /metrics (rates land in the low
        # buckets; still monotone, still aggregable)
        for name, value in _rates(sig).items():
            if value is not None:
                m.observe(k[name], value)

    # ---- drift sentinel --------------------------------------------------

    def window_rates(self) -> "dict[str, float | None]":
        """Aggregate rates over the current window (exact: counts are
        summed, THEN divided — a mean of per-batch rates would weight a
        2-trace wave like a 2000-trace one)."""
        with self._lock:
            win = list(self._window)
        if not win:
            return {k: None for k in RATE_NAMES}
        tot = win[0]
        for s in win[1:]:
            tot = tot.merged(s)
        return _rates(tot)

    def _evaluate(self) -> None:
        # injected drift first (faults.py counted-call discipline: the
        # site counter advances once per evaluation, so a chaos plan
        # like "quality:fail@3" names an exact wave)
        rule = faults.check("quality")
        agg = self.window_rates()
        with self._lock:
            warm = self.waves >= self.min_waves
        exceeded = [k for k in RATE_NAMES
                    if warm and agg[k] is not None
                    and agg[k] > self.baseline[k] * self.drift_tol]
        if rule is not None:
            exceeded = exceeded or ["injected"]
        drifted = bool(exceeded)
        with self._lock:
            transition = drifted and not self._drifted
            self._drifted = drifted
            if transition:
                self.drift_events += 1
        if not transition:
            return
        # one event, one dump: only the transition INTO drift
        # post-mortems; the bounded
        # max_dumps budget is shared with every other fault site
        self.metrics.count(self._keys["drift"])
        tr = tracing.tracer()
        tr.instant("quality_drift", metro=self.metro,
                   exceeded=",".join(exceeded))
        tr.post_mortem("quality_drift", failing="quality_window",
                       metro=self.metro, exceeded=",".join(exceeded),
                       **{k: (None if agg[k] is None
                              else round(agg[k], 4))
                          for k in RATE_NAMES})

    # ---- read side -------------------------------------------------------

    @property
    def drifted(self) -> bool:
        with self._lock:
            return self._drifted

    def health(self) -> dict:
        """The /health block: window aggregate + sentinel state. Small
        on purpose — the full series live at /stats and /metrics."""
        agg = self.window_rates()
        with self._lock:
            waves, events, drifted = (self.waves, self.drift_events,
                                      self._drifted)
        return {
            "enabled": self.enabled,
            "window_waves": min(waves, self.window_size),
            "drifted": drifted,
            "drift_events": events,
            **{k: (None if agg[k] is None else round(agg[k], 4))
               for k in RATE_NAMES},
        }

    def snapshot(self) -> dict:
        """stats()-shaped view (health + the baseline in force): the
        stream pipelines' stats carry it."""
        return {**self.health(),
                "baseline": dict(self.baseline),
                "drift_tol": self.drift_tol}
