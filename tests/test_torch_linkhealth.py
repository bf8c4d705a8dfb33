"""The port's link-health telemetry (reporter_tpu_torch/utils/
linkhealth.py) against the JAX package's, on the CPU.

tests/test_linkhealth.py on the port, each case run on both packages'
samplers with the same injected probe and clock, and the outcomes
compared at tolerance 0: the mood classification and its thresholds
(environment defaults included), the worst-mood window with its medians
and its fallback, the bounded ring, the gauges and their Prometheus
names, the measured duty, the dead transition's one post-mortem, the
dispatch-timeout note (and its wiring into the matcher's watchdog), the
breaker that stops spawning probe threads, the env gate, and the
``/health`` ``link`` block of an app. The port's default probe on a CPU
device reports mood "cpu", as the JAX module does with no accelerator;
a probe that fails is "dead" with no reading.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from reporter_tpu.utils import linkhealth as jlh
from reporter_tpu.utils import tracing as jtracing
from reporter_tpu.utils.metrics import MetricsRegistry as JMetricsRegistry
from reporter_tpu_torch.utils import linkhealth as plh
from reporter_tpu_torch.utils import tracing as ptracing
from reporter_tpu_torch.utils.metrics import MetricsRegistry
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

PACKAGES = {"jax": (jlh, JMetricsRegistry, jtracing),
            "port": (plh, MetricsRegistry, ptracing)}


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _both(probe_factory, **kw):
    """{package: sampler} with a fresh probe each and one fake clock each
    (the clocks advance together)."""
    kw.setdefault("period_s", 60.0)
    kw.setdefault("dead_timeout_s", 2.0)
    out = {}
    for name, (lh, _, _) in PACKAGES.items():
        out[name] = lh.LinkHealthSampler(probe=probe_factory(), clock=Clock(),
                                         **kw)
    return out


def _sample(samplers):
    got = {n: s.sample_once() for n, s in samplers.items()}
    for s in samplers.values():
        s.clock.now += 1.0
    return got


def _same(got):
    j, p = got["jax"].to_json(), got["port"].to_json()
    assert p == j
    return p


@pytest.mark.parametrize("reading,mood", [
    ((0.13, 25.0), "healthy"), ((0.9, 25.0), "degraded"),
    ((0.13, 1.0), "degraded"), ((0.4, 5.0), "healthy"),
    ((None, 12.0), "healthy"), ((0.5, None), "degraded"),
    ((None, None), "cpu")])
def test_classification_and_default_thresholds(reading, mood, monkeypatch):
    for var in ("RTPU_LINK_DEGRADED_RTT_MS", "RTPU_LINK_DEGRADED_MBPS",
                "RTPU_LINK_DEAD_S", "RTPU_LINK_PROBE_PERIOD_S",
                "RTPU_LINK_PROBE_BYTES"):
        monkeypatch.delenv(var, raising=False)
    ss = _both(lambda: (lambda n: reading))
    assert _same(_sample(ss))["mood"] == mood
    for attr in ("period_s", "probe_bytes", "degraded_rtt_s",
                 "degraded_mbps", "dead_timeout_s"):
        pj = plh.LinkHealthSampler(probe=lambda n: reading)
        jj = jlh.LinkHealthSampler(probe=lambda n: reading)
        assert getattr(pj, attr) == getattr(jj, attr), attr


def test_thresholds_follow_the_environment(monkeypatch):
    monkeypatch.setenv("RTPU_LINK_DEGRADED_RTT_MS", "50")
    monkeypatch.setenv("RTPU_LINK_DEGRADED_MBPS", "30")
    monkeypatch.setenv("RTPU_LINK_PROBE_BYTES", "4096")
    for reading in ((0.06, 40.0), (0.04, 20.0), (0.04, 40.0)):
        ss = _both(lambda: (lambda n: reading))
        _same(_sample(ss))
        assert ss["port"].probe_bytes == ss["jax"].probe_bytes == 4096


def test_mood_levels_are_the_jax_ones():
    assert plh.MOOD_LEVELS == jlh.MOOD_LEVELS


def test_probe_exception_and_timeout_classify_dead():
    def boom(n):
        raise RuntimeError("the copy failed")

    ss = _both(lambda: boom)
    x = _same(_sample(ss))
    assert x["mood"] == "dead" and x["source"] == "probe_error:RuntimeError"
    assert x["rtt_ms"] is None and x["mbps"] is None
    assert ss["port"].dead_probes_total == ss["jax"].dead_probes_total == 1

    def stall(n):
        time.sleep(0.6)
        return 0.1, 25.0

    ss = _both(lambda: stall, dead_timeout_s=0.05)
    x = _same(_sample(ss))
    assert x["mood"] == "dead" and x["source"] == "probe_timeout"


def test_default_probe_on_a_cpu_device_reports_cpu():
    s = plh.LinkHealthSampler(dead_timeout_s=5.0, device="cpu")
    x = s.sample_once()
    assert x.mood == "cpu" and x.rtt_s is None and x.mbps is None
    assert plh._device_probe(1024, "cpu") == (None, None)
    # no device named and no card here: the CPU is what is served
    assert plh.LinkHealthSampler().probe_device().type == "cpu"


def test_window_worst_mood_medians_and_fallback():
    def factory():
        moods = iter([(0.10, 25.0), (0.12, 24.0), None, (0.3, 10.0)])

        def probe(n):
            v = next(moods)
            if v is None:
                raise RuntimeError("dead spell")
            return v

        return probe

    ss = _both(factory)
    t0 = {n: s.clock() for n, s in ss.items()}
    for _ in range(4):
        _same(_sample(ss))
    wins = {n: s.window(since=t0[n]) for n, s in ss.items()}
    assert wins["port"] == wins["jax"]
    assert wins["port"]["mood"] == "dead" and wins["port"]["samples"] == 4
    later = {n: s.window(since=s.clock() + 100.0) for n, s in ss.items()}
    assert later["port"] == later["jax"] and later["port"]["samples"] == 1
    tail = {n: s.window(since=t0[n] + 3.0) for n, s in ss.items()}
    assert tail["port"] == tail["jax"]
    empty = _both(lambda: (lambda n: (0.1, 25.0)))
    assert empty["port"].window() == empty["jax"].window()
    assert empty["port"].window()["mood"] is None


def test_ring_is_bounded():
    ss = _both(lambda: (lambda n: (0.1, 25.0)), ring=8)
    for _ in range(20):
        _sample(ss)
    assert len(ss["port"].samples()) == len(ss["jax"].samples()) == 8
    assert ss["port"].probes_total == ss["jax"].probes_total == 20
    assert [x.to_json() for x in ss["port"].samples()] == \
        [x.to_json() for x in ss["jax"].samples()]


def _series(text):
    return sorted(ln for ln in text.splitlines()
                  if "link" in ln and not ln.startswith("#"))


def test_gauges_publish_into_attached_registries():
    ss = _both(lambda: (lambda n: (0.2, 12.5)))
    regs = {"jax": JMetricsRegistry(), "port": MetricsRegistry()}
    for n, s in ss.items():
        s.attach(regs[n])
    _sample(ss)
    snaps = {n: r.snapshot() for n, r in regs.items()}
    keys = ("link_rtt_ms", "link_mbps", "link_mood", "link_probes",
            "link_dead_probes")
    assert {k: snaps["port"][k] for k in keys} == \
        {k: snaps["jax"][k] for k in keys}
    assert snaps["port"]["link_rtt_ms"] == pytest.approx(200.0)
    assert _series(regs["port"].render_prometheus()) == \
        _series(regs["jax"].render_prometheus())
    for name in ("rtpu_link_rtt_ms", "rtpu_link_mbps", "rtpu_link_mood",
                 "rtpu_link_probes", "rtpu_link_dead_probes"):
        assert name in regs["port"].render_prometheus(), name
    # attach replays the latest sample, without a new probe
    late = MetricsRegistry()
    ss["port"].attach(late)
    assert late.snapshot()["link_mood"] == plh.MOOD_LEVELS["healthy"]


def test_probe_duty_is_measured():
    def probe(n):
        time.sleep(0.01)
        return 0.1, 25.0

    s = plh.LinkHealthSampler(probe=probe, period_s=60.0)
    assert s.probe_duty_pct() is None
    s.start()
    try:
        for _ in range(100):
            if s.probes_total >= 1:
                break
            time.sleep(0.02)
    finally:
        s.stop()
    assert not s.running
    duty = s.probe_duty_pct()
    assert duty is not None and duty > 0.0
    assert s.probe_seconds_total >= 0.01


@pytest.fixture
def dump_dirs(tmp_path):
    """Both packages' flight recorders on, dumping under tmp_path; the
    previous settings restored after."""
    out = {}
    prev = {}
    for name, (_, _, tr_mod) in PACKAGES.items():
        tr = tr_mod.tracer()
        prev[name] = (tr.enabled, tr.dump_dir)
        d = tmp_path / name
        d.mkdir()
        tr.configure(enabled=True, dump_dir=str(d))
        out[name] = (tr, d)
    yield out
    for name, (_, _, tr_mod) in PACKAGES.items():
        tr_mod.tracer().configure(enabled=prev[name][0],
                                  dump_dir=prev[name][1])


def test_dead_transition_dumps_one_post_mortem(dump_dirs):
    def factory():
        calls = iter([(0.1, 25.0), None, None])

        def probe(n):
            v = next(calls)
            if v is None:
                raise RuntimeError("dead")
            return v

        return probe

    ss = _both(factory)
    _sample(ss)                                   # healthy
    before = {n: dump_dirs[n][0].dumps_written for n in ss}
    _same(_sample(ss))                            # healthy → dead: one dump
    _same(_sample(ss))                            # dead → dead: none
    for n in ss:
        tr, d = dump_dirs[n]
        assert tr.dumps_written == before[n] + 1, n
        dumps = [p for p in os.listdir(d) if "link_dead" in p]
        assert len(dumps) == 1, n
        doc = json.load(open(os.path.join(d, dumps[0])))
        assert doc["reason"] == "link_dead"
        assert doc["failing_span"] == "link_probe"


def test_note_dispatch_timeout_records_without_a_dump(dump_dirs):
    ss = _both(lambda: (lambda n: (0.1, 25.0)))
    _sample(ss)
    before = {n: dump_dirs[n][0].dumps_written for n in ss}
    for s in ss.values():
        s.note_dispatch_timeout("dispatch_timeout")
    got = {n: s.latest() for n, s in ss.items()}
    _same(got)
    assert got["port"].mood == "dead"
    assert got["port"].source == "dispatch_timeout"
    for n in ss:
        assert dump_dirs[n][0].dumps_written == before[n]


def test_matcher_watchdog_is_wired_to_linkhealth():
    """The dispatch-timeout branch feeds the link record, in both
    packages."""
    import inspect

    from reporter_tpu.matcher import api as japi
    from reporter_tpu_torch.matcher import api as papi

    assert "linkhealth.note_dispatch_timeout" in inspect.getsource(
        japi.SegmentMatcher._guarded_jax_many)
    assert "linkhealth.note_dispatch_timeout" in inspect.getsource(
        papi.SegmentMatcher._guarded_many)


def test_module_note_forwards_to_the_installed_sampler():
    prev = plh._global
    s = plh.LinkHealthSampler(probe=lambda n: (0.1, 25.0))
    plh.configure(s)
    try:
        plh.note_dispatch_timeout("dispatch_timeout")
        assert s.latest() is not None and s.latest().mood == "dead"
        plh.configure(None)
        plh.note_dispatch_timeout("dispatch_timeout")   # a plain no-op
        assert plh._global is None
    finally:
        plh.configure(prev)


def test_a_dispatch_timeout_reaches_the_link_record(monkeypatch):
    """A matcher whose dispatch hangs past dispatch_timeout_s notes the
    stall in the process sampler (the port's _guarded_many)."""
    from reporter_tpu_torch import faults
    from reporter_tpu_torch.config import CompilerParams, MatcherParams
    from reporter_tpu_torch.matcher.api import (DispatchTimeout,
                                                SegmentMatcher, Trace)
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.tiles.compiler import compile_network

    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0,
                                        osmlr_max_length=200.0))
    prev = plh._global
    s = plh.LinkHealthSampler(probe=lambda n: (0.001, 9000.0))
    plh.configure(s)
    try:
        s.sample_once()
        m = SegmentMatcher(ts, MatcherParams(dispatch_timeout_s=0.5),
                           device="cpu")
        tr = Trace.from_json(synthesize_probe(
            ts, seed=3, num_points=20, gps_sigma=3.0).to_report_json(), ts)
        with faults.use(faults.FaultPlan.parse("dispatch:hang(2)@0")):
            with pytest.raises(DispatchTimeout):
                m.match_many([tr])
        last = s.latest()
        assert last.mood == "dead" and last.source == "dispatch_timeout"
        assert s.window()["mood"] == "dead"
    finally:
        plh.configure(prev)


def test_breaker_open_stops_spawning_probe_threads():
    hang = threading.Event()

    def stuck(n):
        hang.wait(10.0)
        return 0.1, 25.0

    s = plh.LinkHealthSampler(probe=stuck, period_s=60.0,
                              dead_timeout_s=0.02)
    try:
        for _ in range(s._watchdog.cap):
            assert s.sample_once().mood == "dead"
        assert s._watchdog.tripped
        before = threading.active_count()
        x = s.sample_once()
        assert x.mood == "dead" and x.source == "probe_breaker_open"
        assert threading.active_count() == before
    finally:
        hang.set()


@pytest.mark.parametrize("raw,want", [
    (None, True), ("", True), ("0", False), ("1", True), ("off", False),
    ("bogus", ValueError)])
def test_env_gate_default_on_and_strict(raw, want, monkeypatch):
    for lh in (jlh, plh):
        if raw is None:
            monkeypatch.delenv("RTPU_LINK_PROBE", raising=False)
        else:
            monkeypatch.setenv("RTPU_LINK_PROBE", raw)
        if want is ValueError:
            with pytest.raises(ValueError):
                lh.enabled()
        else:
            assert lh.enabled() is want


def test_ensure_serving_respects_the_gate_and_names_the_device(monkeypatch):
    monkeypatch.setenv("RTPU_LINK_PROBE", "0")
    assert plh.ensure_serving(MetricsRegistry(), "cpu") is None
    monkeypatch.delenv("RTPU_LINK_PROBE")
    prev = plh._global
    s = plh.LinkHealthSampler(probe=lambda n: (0.1, 25.0), period_s=60.0)
    plh.configure(s)
    try:
        reg = MetricsRegistry()
        assert plh.ensure_serving(reg, "cpu") is s and s.running
        assert str(s.device) == "cpu"
    finally:
        s.stop()
        plh.configure(prev)


def test_app_health_link_block_and_metrics_equal_the_jax_app(monkeypatch):
    """Both apps over one tile, each with its package's sampler on the
    same fake probe: /health's link block and the rtpu_link_* series
    agree; the port's default sampler on a CPU app reads "cpu"."""
    from reporter_tpu.config import CompilerParams as JCompilerParams
    from reporter_tpu.config import Config as JConfig
    from reporter_tpu.config import MatcherParams as JMatcherParams
    from reporter_tpu.netgen.synthetic import generate_city
    from reporter_tpu.service.app import ReporterApp as JReporterApp
    from reporter_tpu.tiles.compiler import compile_network
    from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
    from reporter_tpu_torch.config import Config
    from reporter_tpu_torch.service.app import ReporterApp
    from reporter_tpu_torch.tiles.tileset import TileSet

    jts = compile_network(generate_city("tiny"),
                          JCompilerParams(reach_radius=500.0,
                                          osmlr_max_length=200.0))
    pts = TileSet.from_arrays(jts.name, jts.meta.origin_lonlat,
                              {f: getattr(jts, f) for f in _ARRAY_FIELDS})
    prev = {"jax": jlh._global, "port": plh._global}
    ss = _both(lambda: (lambda n: (0.13, 25.0)), period_s=600.0)
    jlh.configure(ss["jax"])
    plh.configure(ss["port"])
    apps = {}
    try:
        apps["jax"] = JReporterApp(jts, JConfig(
            matcher=JMatcherParams(candidate_backend="dense")),
            transport=lambda u, b: 200)
        apps["port"] = ReporterApp(pts, Config(),
                                   transport=lambda u, b: 200, device="cpu")
        for s in ss.values():
            s.stop()
        _sample(ss)
        links = {n: a.health()["link"] for n, a in apps.items()}
        assert links["port"].keys() == links["jax"].keys()
        for key in ("mood", "rtt_ms", "mbps"):
            assert links["port"][key] == links["jax"][key], key
        assert links["port"]["mood"] == "healthy"
        assert links["port"]["rtt_ms"] == pytest.approx(130.0)
        assert links["port"]["probe_duty_pct"] is not None
        assert _series(apps["port"].matcher.metrics.render_prometheus()) == \
            _series(apps["jax"].matcher.metrics.render_prometheus())
        monkeypatch.setenv("RTPU_LINK_PROBE", "0")
        off = apps["port"].health()["link"]
        assert off == apps["jax"].health()["link"]
        assert off["mood"] is None and off["probe_duty_pct"] is None
        monkeypatch.delenv("RTPU_LINK_PROBE")
        plh.configure(None)
        cpu = ReporterApp(pts, Config(), transport=lambda u, b: 200,
                          device="cpu")
        try:
            s = plh.sampler()
            s.stop()
            s.sample_once()
            assert cpu.health()["link"]["mood"] == "cpu"
            assert str(s.device) == "cpu"
        finally:
            plh.sampler().stop()
            cpu.close()
    finally:
        for a in apps.values():
            a.close()
        for s in ss.values():
            s.stop()
        jlh.configure(prev["jax"])
        plh.configure(prev["port"])
