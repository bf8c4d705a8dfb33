"""Declarative SLO engine: error budgets and multi-window burn-rate alerts.

Counterpart: reporter_tpu/obs/slo.py (``enabled``, ``window_scale``,
``SloSpec``, ``DEFAULT_SLOS``, ``SloEvaluator``, ``install`` /
``active``), with the same specs, the same arithmetic and the same
``status`` / ``health`` / ``exit_block`` documents and ledger lines.

  - :class:`SloSpec`: an objective over existing registry series: a
    good-event ratio over counters (``ratio``), a latency objective over
    a fixed-bucket histogram (``latency``: "requests under 250 ms" is an
    exact bucket prefix sum, because ``HISTOGRAM_BUCKETS`` is pinned, so
    it merges across workers), or a level ceiling over a gauge
    (``gauge``: sampled each tick into synthetic ``slo_sample_*``
    counters, so a level becomes delta-able and mergeable too).
  - :class:`SloEvaluator`: pushes ``export()`` snapshots into a
    :class:`~reporter_tpu_torch.utils.metrics.SnapshotRing` and computes
    burn per spec from windowed deltas (``delta_since``): an alert fires
    only when burn exceeds a pair's threshold on BOTH its fast and slow
    window. ``RTPU_SLO_SCALE`` scales the windows, so test and smoke runs
    see real transitions in seconds.

A transition is a tracer instant on fire and resolve, ONE bounded
flight-recorder post-mortem per fire (a budget that stays blown dumps
once, not per tick), and an append to an alert ledger
(:class:`~reporter_tpu_torch.utils.eventlog.EventLog`). Burn rates,
budget remaining and alert state publish as ``slo_*`` gauges into the
registry, so ``/metrics`` carries ``rtpu_slo_*``.

Topology-wide evaluation is the same code over another source: the
supervisor passes ``source=lambda: merged_registry().export()``. Burn is
linear over counters and buckets, so the topology's burn over
``merge_exports`` equals the per-worker sum by construction. A merged
evaluator passes ``sample_gauges=False``: the workers already sampled
their own gauges into the synthetic counters, and the merge carries
them.

``obs.slo`` is a leaf lock: it guards only the snapshot ring, the
throttle stamp and the alert state; the export pull, gauge publication,
ledger append and tracer all run outside it.
"""

from __future__ import annotations

import dataclasses
import os
import time

from reporter_tpu_torch.utils import locks, tracing
from reporter_tpu_torch.utils.metrics import (HISTOGRAM_BUCKETS, SnapshotRing,
                                        _split_labels, labeled)

__all__ = ["SloSpec", "SloEvaluator", "DEFAULT_SLOS", "DEFAULT_WINDOWS",
           "enabled", "window_scale", "install", "active"]

_ENV_GATE = "RTPU_SLO"
_ENV_SCALE = "RTPU_SLO_SCALE"
_ENV_TICK = "RTPU_SLO_TICK"


def enabled(env: "dict[str, str] | None" = None) -> bool:
    """``RTPU_SLO`` gate, default ON (strict parse — the config.py lever
    discipline: a typo'd gate must raise, not silently disable the
    error-budget plane)."""
    e = os.environ if env is None else env
    raw = e.get(_ENV_GATE)
    if raw is None or not raw.strip():
        return True
    return tracing.env_flag(raw, strict=True)


def window_scale(env: "dict[str, str] | None" = None) -> float:
    """``RTPU_SLO_SCALE`` multiplier on every spec window (default 1.0).
    Bench/chaos runs set ~0.01 so the production-scale windows transition
    in seconds; the spec FILE stays at production scale, which is what
    the ``--slo`` validator checks."""
    e = os.environ if env is None else env
    raw = e.get(_ENV_SCALE)
    if raw is None or not raw.strip():
        return 1.0
    scale = float(raw)
    if scale <= 0:
        raise ValueError(f"{_ENV_SCALE} must be > 0, got {raw!r}")
    return scale


# (fast_s, slow_s, burn_threshold) pairs — the Google-SRE page/ticket
# split shrunk to this service's horizon: a fast 1 m / 12 m pair at
# 14.4× burn (budget gone in ~1 h at that rate) and a slow 5 m / 1 h
# pair at 6×. Both windows of a pair must exceed the threshold to alert
# (the fast window alone would page on blips; the slow alone would page
# an hour late).
DEFAULT_WINDOWS = ((60.0, 720.0, 14.4), (300.0, 3600.0, 6.0))


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One committed objective. ``kind``:

    - ``ratio``: bad/total are tuples of counter base names, summed
      across names and label blocks (tuples are what let the publish SLO
      count failures over attempts, or a fleet SLO sum a success counter
      with a failure counter for its denominator);
    - ``latency``: ``series`` is an observation series; ``threshold_s``
      MUST sit exactly on the ``HISTOGRAM_BUCKETS`` grid (validated) —
      bad events are the bucket counts strictly above it;
    - ``gauge``: each evaluator tick samples every series of ``gauge``
      against ``ceiling`` into synthetic per-spec counters, turning a
      level into a windowed ratio.
    """

    name: str
    kind: str  # "ratio" | "latency" | "gauge"
    objective: float  # good-event fraction target, e.g. 0.999
    bad: "tuple[str, ...]" = ()
    total: "tuple[str, ...]" = ()
    series: str = ""
    threshold_s: float = 0.0
    gauge: str = ""
    ceiling: float = 0.0
    windows: "tuple[tuple[float, float, float], ...]" = DEFAULT_WINDOWS

    def budget(self) -> float:
        """Error budget = 1 − objective (the burn-rate denominator)."""
        return 1.0 - self.objective

    def metric_names(self) -> "tuple[str, ...]":
        """Every registry series this spec reads — the validator checks
        each against the README metric-inventory block."""
        if self.kind == "ratio":
            return tuple(self.bad) + tuple(self.total)
        if self.kind == "latency":
            return (self.series,)
        return (self.gauge,)


# The committed objectives, the JAX package's: serving availability and
# latency, publish success, dispatch-timeout rate, streaming lag, lease
# reacquire time. The JAX package's ``python -m reporter_tpu.analysis
# --slo`` validates them (windows ordered, burn thresholds consistent
# with the budget, latency thresholds on the histogram grid); the port's
# copy is held equal to them by tests/test_torch_slo.py.
DEFAULT_SLOS = (
    SloSpec("availability", "ratio", 0.999,
            bad=("http_errors",), total=("http_requests",)),
    SloSpec("latency", "latency", 0.99,
            series="request_seconds", threshold_s=0.25),
    SloSpec("publish", "ratio", 0.999,
            bad=("publish_failures",), total=("publish_attempts",)),
    SloSpec("dispatch_timeout", "ratio", 0.999,
            bad=("dispatch_timeout",), total=("match_seconds_count",)),
    SloSpec("stream_lag", "gauge", 0.99,
            gauge="stream_lag", ceiling=5000.0),
    SloSpec("lease_reacquire", "latency", 0.95,
            series="lease_reacquire_seconds", threshold_s=10.0),
)


def _sum_counters(counters: dict, bases: "tuple[str, ...]") -> float:
    tot = 0.0
    for k, v in counters.items():
        if _split_labels(k)[0] in bases:
            tot += float(v)
    return tot


def _sum_hist(hist: dict, base: str) -> "list[int]":
    out = [0] * (len(HISTOGRAM_BUCKETS) + 1)
    for k, buckets in hist.items():
        if _split_labels(k)[0] == base:
            for i, c in enumerate(buckets[:len(out)]):
                out[i] += int(c)
    return out


def _bad_total(spec: SloSpec, delta: dict) -> "tuple[float, float]":
    """(bad, total) event counts for one spec over one delta document."""
    counters = delta.get("counters") or {}
    if spec.kind == "ratio":
        return (_sum_counters(counters, spec.bad),
                _sum_counters(counters, spec.total))
    if spec.kind == "latency":
        buckets = _sum_hist(delta.get("hist") or {}, spec.series)
        idx = HISTOGRAM_BUCKETS.index(spec.threshold_s)
        good = float(sum(buckets[:idx + 1]))
        total = float(sum(buckets))
        return total - good, total
    # gauge: the tick already folded levels into per-spec synthetic
    # counters (exact keys — two gauge specs must never alias)
    bad = float(counters.get(labeled("slo_sample_bad", slo=spec.name),
                             0.0))
    total = float(counters.get(labeled("slo_sample_total",
                                       slo=spec.name), 0.0))
    return bad, total


class SloEvaluator:
    """Periodic burn-rate evaluation of ``specs`` over ``source()``
    exports, publishing into ``registry`` (see module docstring).

    ``clock`` is injectable (bench/tests drive window transitions
    deterministically); ``min_tick_s`` self-throttles callers that tick
    per wave/poll; ``ledger`` is an :class:`EventLog` receiving one
    entry per alert transition.
    """

    def __init__(self, registry, *, source=None, specs=DEFAULT_SLOS,
                 ledger=None, clock=time.monotonic,
                 scale: "float | None" = None,
                 min_tick_s: "float | None" = None,
                 sample_gauges: bool = True,
                 enabled_override: "bool | None" = None):
        self.registry = registry
        self._source = source if source is not None else registry.export
        self.enabled = (enabled() if enabled_override is None
                        else bool(enabled_override))
        s = window_scale() if scale is None else float(scale)
        self.scale = s
        self.specs = tuple(specs)
        self.ledger = ledger
        self._clock = clock
        self._sample_gauges = bool(sample_gauges)
        # scaled (fast, slow, threshold) triples per spec, fast-first
        self._windows = {
            spec.name: tuple(sorted((f * s, sl * s, thr)
                                    for f, sl, thr in spec.windows))
            for spec in self.specs}
        fastest = min((w[0][0] for w in self._windows.values()
                       if w), default=60.0)
        if min_tick_s is None:
            raw = os.environ.get(_ENV_TICK)
            min_tick_s = (float(raw) if raw and raw.strip()
                          else max(0.05, fastest / 6.0))
        self.min_tick_s = float(min_tick_s)
        self._lock = locks.named_lock("obs.slo")
        self._ring = SnapshotRing()
        self._last_tick: "float | None" = None
        self._active: "dict[str, bool]" = {
            spec.name: False for spec in self.specs}
        self._state: "dict[str, dict]" = {}
        self.ticks = 0
        self.alerts_total = 0

    # ---- evaluation ------------------------------------------------------

    def tick(self, now: "float | None" = None,
             force: bool = False) -> bool:
        """One evaluation pass; returns False when throttled/disabled.
        The lock guards only the throttle stamp, ring and alert state —
        export pull, gauge sampling, metric publication, ledger append
        and tracer all run outside it."""
        if not self.enabled:
            return False
        if now is None:
            now = self._clock()
        with self._lock:
            if (not force and self._last_tick is not None
                    and now - self._last_tick < self.min_tick_s):
                return False
            self._last_tick = now
            self.ticks += 1
        export = self._source()
        if self._sample_gauges and self._sample(export):
            export = self._source()
        fired, resolved = [], []
        with self._lock:
            self._ring.push(now, export)
            for spec in self.specs:
                st = self._evaluate(spec, now)
                self._state[spec.name] = st
                was = self._active[spec.name]
                self._active[spec.name] = st["alerting"]
                if st["alerting"] and not was:
                    fired.append((spec, st))
                    self.alerts_total += 1
                elif was and not st["alerting"]:
                    resolved.append((spec, st))
            states = dict(self._state)
        self._publish(states)
        for spec, st in fired:
            self._transition("fire", spec, st)
        for spec, st in resolved:
            self._transition("resolve", spec, st)
        return True

    def _sample(self, export: dict) -> bool:
        """Fold current gauge levels into per-spec synthetic counters
        (one good/bad event per matching series per tick) so gauge SLOs
        ride the same delta/merge math as everything else."""
        gauges = export.get("gauges") or {}
        sampled = False
        for spec in self.specs:
            if spec.kind != "gauge":
                continue
            bad = total = 0
            for k, v in gauges.items():
                if _split_labels(k)[0] == spec.gauge:
                    total += 1
                    if float(v) > spec.ceiling:
                        bad += 1
            if total:
                sampled = True
                self.registry.count(
                    labeled("slo_sample_total", slo=spec.name), total)
                if bad:
                    self.registry.count(
                        labeled("slo_sample_bad", slo=spec.name), bad)
        return sampled

    def _evaluate(self, spec: SloSpec, now: float) -> dict:
        """Burn per window pair from ring deltas (lock held: pure dict
        math only). Zero traffic over a window is zero burn — an idle
        service is not out of budget."""
        budget = spec.budget()
        pairs = []
        alerting = False
        for fast_s, slow_s, thr in self._windows[spec.name]:
            burns = []
            for win in (fast_s, slow_s):
                delta, span = self._ring.delta_since(win, now)
                if delta is None:
                    burns.append(0.0)
                    continue
                bad, total = _bad_total(spec, delta)
                ratio = (bad / total) if total > 0 else 0.0
                burns.append(ratio / budget if budget > 0 else 0.0)
            pair_alerting = (burns[0] >= thr and burns[1] >= thr)
            alerting = alerting or pair_alerting
            pairs.append({"fast_s": fast_s, "slow_s": slow_s,
                          "threshold": thr, "burn_fast": burns[0],
                          "burn_slow": burns[1],
                          "alerting": pair_alerting})
        longest = max(p["slow_s"] for p in pairs)
        budget_burn = next(p["burn_slow"] for p in pairs
                           if p["slow_s"] == longest)
        return {"alerting": alerting, "pairs": pairs,
                "burn_fast": pairs[0]["burn_fast"],
                "burn_slow": pairs[0]["burn_slow"],
                "budget_remaining": max(0.0, 1.0 - budget_burn)}

    def _publish(self, states: "dict[str, dict]") -> None:
        m = self.registry
        for name, st in states.items():
            m.gauge(labeled("slo_burn_fast", slo=name), st["burn_fast"])
            m.gauge(labeled("slo_burn_slow", slo=name), st["burn_slow"])
            m.gauge(labeled("slo_budget_remaining", slo=name),
                    st["budget_remaining"])
            m.gauge(labeled("slo_alert_active", slo=name),
                    1.0 if st["alerting"] else 0.0)

    def _transition(self, event: str, spec: SloSpec, st: dict) -> None:
        """Instant on both edges, ONE bounded
        post-mortem per fire (a budget that stays blown dumps once),
        ledger entry on both — a fencing-style transition that vanished
        from the ledger would be undebuggable."""
        tr = tracing.tracer()
        args = {"slo": spec.name,
                "burn_fast": round(st["burn_fast"], 3),
                "burn_slow": round(st["burn_slow"], 3),
                "budget_remaining": round(st["budget_remaining"], 4)}
        tr.instant(f"slo_{event}", **args)
        if event == "fire":
            self.registry.count(labeled("slo_alerts_total",
                                        slo=spec.name))
            tr.post_mortem("slo_alert", failing=spec.name, **args)
        if self.ledger is not None:
            self.ledger.append({"t": round(time.time(), 3),
                                "event": event, **args})

    # ---- read side -------------------------------------------------------

    def status(self) -> dict:
        """The ``GET /slo`` body: full per-spec burn/pair detail."""
        with self._lock:
            states = {k: dict(v) for k, v in self._state.items()}
            ticks, total = self.ticks, self.alerts_total
        return {"enabled": self.enabled, "scale": self.scale,
                "ticks": ticks, "alerts_total": total,
                "slos": states,
                "active": sorted(k for k, v in states.items()
                                 if v.get("alerting"))}

    def health(self) -> dict:
        """The ``/health`` roll-up: small on purpose (full detail at
        ``/slo``)."""
        with self._lock:
            states = dict(self._state)
            total = self.alerts_total
        return {"enabled": self.enabled,
                "alerting": sorted(k for k, v in states.items()
                                   if v.get("alerting")),
                "alerts_total": total,
                "budget_remaining": {
                    k: round(v["budget_remaining"], 4)
                    for k, v in states.items()}}

    def exit_block(self) -> dict:
        """The worker-CLI exit-JSON block (rides member exit reports
        next to the link and quality blocks)."""
        h = self.health()
        with self._lock:
            ticks = self.ticks
        return {"active": h["alerting"], "alerts_total":
                h["alerts_total"], "ticks": ticks,
                "budget_remaining": h["budget_remaining"]}


# ---- process-global seam (the faults.install shape) ----------------------
#
# Apps, workers and the supervisor hold PER-INSTANCE evaluators; nothing
# in the package installs globally. The seam exists so embedders can
# share one evaluator, and a test that installs one puts it back.

_installed: "SloEvaluator | None" = None


def install(evaluator: "SloEvaluator | None") -> None:
    global _installed
    _installed = evaluator


def active() -> "SloEvaluator | None":
    return _installed
