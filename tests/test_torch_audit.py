"""The sampled shadow-oracle audit (reporter_tpu_torch/quality/audit.py)
against the JAX package's auditor (tests/test_quality.py's auditor cases,
on the port).

Exact throughout (tolerance 0): the seeded sampling schedule and the
counted decisions equal the JAX auditor's for the same seed and call
sequence; an end-to-end audit of the port's CPU matcher counts the
disagreement the JAX auditor counts for the JAX matcher on the same
traces; shedding, timeouts, the oracle's telemetry, the degraded-batch
gate and the lazy process auditor behave as the JAX package's.
"""

import time

import numpy as np
import pytest

from reporter_tpu import faults as jfaults
from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.quality import audit as jaudit
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads,
    fresh_link_sampler)
from reporter_tpu_torch import faults
from reporter_tpu_torch.config import Config, MatcherParams
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen.traces import (
    synthesize_fleet as psynthesize_fleet)
from reporter_tpu_torch.quality import audit
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils.metrics import MetricsRegistry, labeled

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_COUNTS = ("audit_rate", "audit_calls", "audited_batches", "audited_traces",
           "audit_timeouts", "audit_skips", "disagreement_rate")


@pytest.fixture(scope="module")
def jtiles():
    return compile_network(generate_city("tiny"),
                           JCompilerParams(reach_radius=500.0,
                                           osmlr_max_length=250.0))


@pytest.fixture(scope="module")
def tiles(jtiles):
    return TileSet.from_arrays(jtiles.name, jtiles.meta.origin_lonlat,
                               {f: getattr(jtiles, f) for f in _ARRAY_FIELDS})


def _traces(jtiles, n, points, seed):
    fleet = synthesize_fleet(jtiles, n, num_points=points, seed=seed)
    return ([Trace(p.uuid, p.xy.astype(np.float32), p.times) for p in fleet],
            [JTrace(p.uuid, p.xy.astype(np.float32), p.times)
             for p in fleet])


def _jmatcher(jtiles, **kw):
    return JSegmentMatcher(jtiles, JConfig(
        matcher_backend="jax",
        matcher=JMatcherParams(candidate_backend="dense", **kw)))


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seed,rate", [(0, 1.0 / 256.0), (11, 0.3),
                                       (12, 0.3), (7, 0.05)])
def test_sampling_schedule_equals_the_jax_auditor(seed, rate):
    a = audit.ShadowAuditor(rate=rate, seed=seed)
    j = jaudit.ShadowAuditor(rate=rate, seed=seed)
    try:
        assert [a._rng.random() for _ in range(512)] == \
            [j._rng.random() for _ in range(512)]
    finally:
        a.stop()
        j.stop()


def test_env_defaults_equal_the_jax_auditor(monkeypatch):
    monkeypatch.setenv("RTPU_QUALITY_AUDIT_RATE", "0.5")
    monkeypatch.setenv("RTPU_QUALITY_AUDIT_TRACES", "3")
    monkeypatch.setenv("RTPU_QUALITY_SEED", "9")
    a, j = audit.ShadowAuditor(), jaudit.ShadowAuditor()
    try:
        for f in ("rate", "max_traces", "timeout_s", "duty_pct_cap",
                  "min_interval_s"):
            assert getattr(a, f) == getattr(j, f), f
        assert a._rng.random() == j._rng.random()
    finally:
        a.stop()
        j.stop()


def test_counted_decisions_equal_the_jax_auditor(jtiles, tiles):
    """One call sequence on a fake clock (warm-up interval, spacing,
    the duty cap, the queue cap): the same picks, skips and enqueues."""
    traces, jtraces = _traces(jtiles, 3, 30, 2)

    class Stub:
        def __init__(self, ts):
            self.ts = ts
            self.metrics = MetricsRegistry()

    def run(mod, ts, tr):
        clock = FakeClock()
        a = mod.ShadowAuditor(rate=0.6, seed=5, duty_pct_cap=50.0,
                              min_interval_s=2.0, queue_cap=2, clock=clock)
        a._ensure_worker = lambda: None          # keep the queue: no worker
        out = []
        for i in range(40):
            clock.now += 0.7
            if i == 25:
                a.audit_seconds_total = 1e6      # past the duty cap
            out.append(a.maybe_audit(Stub(ts), tr, [[]] * len(tr)))
        counts = (a.calls, a.sampled, a.skipped_interval,
                  a.skipped_budget, a.skipped_queue, len(a._queue))
        a.stop()
        return out, counts

    got = run(audit, tiles, traces)
    assert got == run(jaudit, jtiles, jtraces)
    assert got[1][1] == 2 and got[1][4] > 0      # the queue cap shed


def test_audit_end_to_end_counts_the_jax_disagreement(jtiles, tiles):
    traces, jtraces = _traces(jtiles, 5, 50, 9)
    m = SegmentMatcher(tiles, device="cpu")
    jm = _jmatcher(jtiles)
    stats = []
    for mod, matcher, tr in ((audit, m, traces), (jaudit, jm, jtraces)):
        out = matcher.match_many(tr)
        a = mod.ShadowAuditor(rate=1.0, max_traces=2, timeout_s=60.0,
                              duty_pct_cap=100.0, min_interval_s=0.0)
        try:
            assert a.maybe_audit(matcher, tr, out)
            assert a.drain(60.0)
            stats.append({k: a.stats()[k] for k in _COUNTS})
        finally:
            a.stop()
    assert stats[0] == stats[1]
    assert stats[0]["audited_batches"] == 1
    assert stats[0]["audited_traces"] == 2
    assert stats[0]["audit_timeouts"] == 0
    assert 0.0 <= stats[0]["disagreement_rate"] <= 1.0
    snap = m.metrics.snapshot()
    assert snap[labeled("quality_audit_batches", metro=tiles.name)] == 1
    assert labeled("quality_audit_disagreement_p50", metro=tiles.name) in snap


def test_duty_cap_interval_and_rate_zero_are_counted(tiles):
    m = SegmentMatcher(tiles, device="cpu")
    traces = [Trace(p.uuid, p.xy.astype(np.float32), p.times)
              for p in psynthesize_fleet(tiles, 2, num_points=30, seed=2)]
    out = m.match_many(traces)
    a = audit.ShadowAuditor(rate=1.0, duty_pct_cap=0.0, min_interval_s=0.0)
    a.audit_seconds_total = 1.0          # any spend is past a 0% cap
    try:
        assert not a.maybe_audit(m, traces, out)
        assert a.stats()["audit_skips"] == 1
        assert a.stats()["audited_batches"] == 0
    finally:
        a.stop()
    z = audit.ShadowAuditor(rate=0.0)    # rate 0: not even a call
    assert not z.maybe_audit(m, traces, out)
    assert z.stats()["audit_calls"] == 0
    z.stop()
    clock = FakeClock()
    iv = audit.ShadowAuditor(rate=1.0, duty_pct_cap=100.0,
                             min_interval_s=0.05, clock=clock)
    try:
        assert not iv.maybe_audit(m, traces, out)   # the warm-up interval
        clock.now += 0.06
        assert iv.maybe_audit(m, traces, out)
        assert not iv.maybe_audit(m, traces, out)   # spacing
        assert iv.skipped_interval == 2
        assert iv.stats()["audit_skips"] == 2
        assert iv.drain(60.0)
    finally:
        iv.stop()


def test_audit_timeout_is_counted_not_fatal(tiles):
    class SlowOracle:
        def match_many(self, traces):
            time.sleep(2.0)
            return [[] for _ in traces]

    class StubMatcher:
        def __init__(self):
            self.ts = tiles
            self.metrics = MetricsRegistry()
            self._quality_audit_oracle = SlowOracle()

    stub = StubMatcher()
    a = audit.ShadowAuditor(rate=1.0, timeout_s=0.2, duty_pct_cap=100.0,
                            min_interval_s=0.0)
    try:
        assert a.maybe_audit(stub, [object()], {0: []})
        assert a.drain(30.0)
        st = a.stats()
        assert st["audit_timeouts"] == 1 and st["audited_batches"] == 0
        assert stub.metrics.snapshot()[labeled(
            "quality_audit_timeouts", metro=tiles.name)] == 1
        # the abandoned thread owns the old oracle: the reference goes
        assert stub._quality_audit_oracle is None
    finally:
        a.stop()


def test_oracle_instances_keep_quality_telemetry_off(tiles):
    m = SegmentMatcher(tiles, device="cpu")
    fb = m._fallback_matcher()
    assert fb.quality.enabled is False and fb.backend == "reference_cpu"
    a = audit.ShadowAuditor(rate=0.0)
    try:
        ao = a._audit_oracle(m)
        assert ao.quality.enabled is False
        assert ao is not m._fallback            # its own instance
        assert a._audit_oracle(m) is ao
    finally:
        a.stop()


def test_degraded_batches_are_not_audited(jtiles, tiles,
                                         fresh_link_sampler):
    """A batch the oracle served (watchdog fallback) is not offered to
    the audit; the next healthy device batch is. As in the JAX matcher.
    The timeout leaves the healthy batch (tens of ms) a wide margin, so
    a loaded host cannot time it out too."""
    traces, jtraces = _traces(jtiles, 3, 30, 13)
    _jmatcher(jtiles).match_many(jtraces)      # the JAX side compiles first
    calls = []
    for fmod, amod, m, tr in (
            (faults, audit, SegmentMatcher(tiles, Config(
                matcher=MatcherParams(dispatch_timeout_s=2.0,
                                      dispatch_fallback="reference_cpu")),
                device="cpu"), traces),
            (jfaults, jaudit, _jmatcher(
                jtiles, dispatch_timeout_s=2.0,
                dispatch_fallback="reference_cpu"), jtraces)):
        a = amod.ShadowAuditor(rate=1.0, duty_pct_cap=100.0,
                               min_interval_s=0.0)
        prev = amod._global
        amod.configure(a)
        try:
            with fmod.use(fmod.FaultPlan.parse("dispatch:hang(4)@0")):
                degraded = m.match_many(tr)     # served by the oracle
            assert m.metrics.value("dispatch_timeout") == 1
            assert m.metrics.value("dispatch_fallback") == 1
            first = a.stats()["audit_calls"]
            m.match_many(tr)                    # a healthy device batch
            assert m.metrics.value("dispatch_timeout") == 1
            calls.append((first, a.stats()["audit_calls"],
                          [[r.to_json() for r in x] for x in degraded]))
            assert a.drain(60.0)
        finally:
            amod.configure(prev)
            a.stop()
    assert calls[0] == calls[1]
    assert calls[0][:2] == (0, 1)


def test_process_auditor_is_lazy_and_swappable():
    prev = audit._global
    try:
        audit.configure(None)
        a = audit.auditor()
        assert audit.auditor() is a and audit._global is a
        fake = audit.ShadowAuditor(rate=0.0)
        audit.configure(fake)
        assert audit.auditor() is fake
        fake.stop()
        audit.configure(None)
        assert audit.auditor() is not fake
    finally:
        audit.configure(prev)
