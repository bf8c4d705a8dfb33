"""The port's SLO plane (reporter_tpu_torch/obs/slo.py) and its one JSONL
event log (utils/eventlog.py) against the JAX package's, on the CPU.

Tolerance 0 throughout. The same appends give byte-equal event-log files.
One timed sequence of registry operations under a fake clock (and a fixed
wall clock for the ledger's stamps) goes through a JAX and a port
``SloEvaluator``: for every spec's true-positive arm, the clean twin and
an idle service (tests/test_slo.py's cases), ``status()``, ``health()``,
``exit_block()``, the registries' exports and the alert-ledger files are
equal. The env gate and the window scale parse alike, the committed specs
are the same, and the report app's ``/slo`` and ``/health`` ``slo`` equal
the JAX app's on the same requests.
"""

import dataclasses
import io
import json
import time

import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.obs import slo as jslo
from reporter_tpu.service.app import make_app as jmake_app
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from reporter_tpu.utils import eventlog as jeventlog
from reporter_tpu.utils import metrics as jmetrics
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import Config, ServiceConfig
from reporter_tpu_torch.obs import slo
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils import eventlog, metrics

WALL = 1_700_000_000.25     # the ledger's wall clock, pinned


# ---------------------------------------------------------------------------
# utils/eventlog.py


def _append_all(log):
    log.append({"event": "a", "n": 1, "x": 0.1})
    log.extend([{"event": "b", "nested": {"k": [1, 2]}}, {"event": "c"}])
    log.extend([])
    log.append({"event": "unicode", "s": "café"})


def test_eventlog_files_byte_equal(tmp_path):
    jp, pp = tmp_path / "j.jsonl", tmp_path / "p.jsonl"
    _append_all(jeventlog.EventLog(str(jp)))
    _append_all(eventlog.EventLog(str(pp)))
    assert jp.read_bytes() == pp.read_bytes()
    assert eventlog.read_events(str(jp)) == jeventlog.read_events(str(pp))


@pytest.mark.parametrize("tail", [b'{"event": "torn', b"garbage\n",
                                  b"\n\n", b""])
def test_eventlog_torn_tail_and_reader_alike(tmp_path, tail):
    """A torn or garbage tail: both readers stop at the same line, and
    reopening truncates it to the same bytes."""
    files = []
    for name, mod in (("j", jeventlog), ("p", eventlog)):
        path = tmp_path / f"{name}.jsonl"
        mod.EventLog(str(path)).append({"event": "ok"})
        with open(path, "ab") as f:
            f.write(tail + b'{"event": "after"}\n' if tail == b"garbage\n"
                    else tail)
        files.append((path, mod))
    (jpath, _), (ppath, _) = files
    assert eventlog.read_events(str(ppath)) == \
        jeventlog.read_events(str(jpath))
    jeventlog.EventLog(str(jpath)).append({"event": "reopened"})
    eventlog.EventLog(str(ppath)).append({"event": "reopened"})
    assert jpath.read_bytes() == ppath.read_bytes()


# ---------------------------------------------------------------------------
# SloEvaluator under one fake clock


def _healthy(reg):
    reg.count("http_requests", 10)
    reg.count("publish_attempts", 10)
    reg.observe("request_seconds", 0.01)
    reg.observe("match_seconds", 0.005)
    reg.observe("lease_reacquire_seconds", 0.5)
    reg.gauge("stream_lag", 10.0)


_CLASS_FAULTS = {   # tests/test_slo.py's true-positive feeders
    "availability": lambda reg: (_healthy(reg),
                                 reg.count("http_errors", 10)),
    "latency": lambda reg: (reg.count("http_requests", 10),
                            reg.observe("request_seconds", 1.0)),
    "publish": lambda reg: (_healthy(reg),
                            reg.count("publish_failures", 10)),
    "dispatch_timeout": lambda reg: (reg.observe("match_seconds", 0.005),
                                     reg.count("dispatch_timeout", 1)),
    "stream_lag": lambda reg: (_healthy(reg),
                               reg.gauge("stream_lag", 99999.0)),
    "lease_reacquire": lambda reg: (
        _healthy(reg), reg.observe("lease_reacquire_seconds", 25.0)),
}


class _Twin:
    """A JAX and a port evaluator, each over its own registry and ledger,
    ticked at the same fake times with the same registry operations."""

    def __init__(self, tmp_path, **kw):
        self.now = 0.0
        self.sides = []
        for name, mmod, smod, emod in (
                ("jax", jmetrics, jslo, jeventlog),
                ("port", metrics, slo, eventlog)):
            reg = mmod.MetricsRegistry()
            ledger = emod.EventLog(str(tmp_path / f"alerts_{name}.jsonl"))
            ev = smod.SloEvaluator(reg, clock=lambda: self.now,
                                   ledger=ledger, scale=0.1,
                                   min_tick_s=0.0, enabled_override=True,
                                   **kw)
            self.sides.append((reg, ev, ledger))

    def drive(self, seconds, feed):
        for _ in range(seconds):
            self.now += 1.0
            for reg, ev, _ in self.sides:
                feed(reg)
                ev.tick()

    def assert_equal(self):
        (jreg, jev, jled), (preg, pev, pled) = self.sides
        assert pev.status() == jev.status()
        assert pev.health() == jev.health()
        assert pev.exit_block() == jev.exit_block()
        pexp, jexp = preg.export(), jreg.export()
        assert pexp == jexp
        assert _bytes(pled.path) == _bytes(jled.path)
        return jev


def _bytes(path):
    """A file's bytes; None when it was never written (no transition)."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


@pytest.fixture
def wall(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)


@pytest.mark.parametrize("name", sorted(_CLASS_FAULTS))
def test_true_positive_arm_equal(tmp_path, wall, name):
    tw = _Twin(tmp_path)
    tw.drive(40, _CLASS_FAULTS[name])
    ev = tw.assert_equal()
    assert name in ev.status()["active"]
    tw.drive(400, _healthy)                 # recovery resolves it
    ev = tw.assert_equal()
    assert name not in ev.status()["active"]
    events = [e["event"] for e in eventlog.read_events(
        str(tmp_path / "alerts_port.jsonl")) if e["slo"] == name]
    assert events == ["fire", "resolve"]


def test_clean_twin_and_idle_equal(tmp_path, wall):
    tw = _Twin(tmp_path)
    tw.drive(400, _healthy)
    ev = tw.assert_equal()
    assert ev.alerts_total == 0 and ev.status()["active"] == []
    tw.drive(50, lambda reg: None)          # idle: zero burn, no alert
    ev = tw.assert_equal()
    assert ev.alerts_total == 0


def test_unsampled_gauges_equal(tmp_path, wall):
    """The merged-evaluator mode (``sample_gauges=False``) alike."""
    tw = _Twin(tmp_path, sample_gauges=False)
    tw.drive(30, _CLASS_FAULTS["stream_lag"])
    ev = tw.assert_equal()
    assert "stream_lag" not in ev.status()["active"]


def test_throttle_and_disabled_alike():
    for smod, mmod in ((jslo, jmetrics), (slo, metrics)):
        clock = {"now": 100.0}
        ev = smod.SloEvaluator(mmod.MetricsRegistry(),
                               clock=lambda: clock["now"], min_tick_s=5.0,
                               enabled_override=True)
        got = [ev.tick(), ev.tick(), ev.tick(force=True)]
        clock["now"] += 5.0
        got.append(ev.tick())
        assert got == [True, False, True, True] and ev.ticks == 3
        off = smod.SloEvaluator(mmod.MetricsRegistry(),
                                enabled_override=False)
        assert not off.tick(force=True)
        assert off.status()["enabled"] is False


@pytest.mark.parametrize("env", [
    {}, {"RTPU_SLO": ""}, {"RTPU_SLO": "  "}, {"RTPU_SLO": "0"},
    {"RTPU_SLO": "1"}, {"RTPU_SLO": "true"}, {"RTPU_SLO": "off"},
    {"RTPU_SLO": "yep"}, {"RTPU_SLO": "bogus"},
    {"RTPU_SLO_SCALE": "0.25"}, {"RTPU_SLO_SCALE": "-1"},
    {"RTPU_SLO_SCALE": "0"}, {"RTPU_SLO_SCALE": "abc"},
    {"RTPU_SLO_SCALE": " "}, {"RTPU_SLO_SCALE": "1e-2"}])
def test_env_gate_and_scale_parse_alike(env):
    for fn in ("enabled", "window_scale"):
        def run(mod):
            try:
                return "ok", getattr(mod, fn)(env)
            except ValueError as exc:
                return "raise", type(exc)
        assert run(slo) == run(jslo), (fn, env)


def test_committed_specs_equal():
    assert [dataclasses.asdict(s) for s in slo.DEFAULT_SLOS] == \
        [dataclasses.asdict(s) for s in jslo.DEFAULT_SLOS]
    assert slo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS


def test_install_seam():
    ev = slo.SloEvaluator(metrics.MetricsRegistry(), enabled_override=True)
    slo.install(ev)
    try:
        assert slo.active() is ev
    finally:
        slo.install(None)
    assert slo.active() is None


# ---------------------------------------------------------------------------
# the report app's /slo and /health slo


URL = "http://datastore.test/"


def _wsgi(app, method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    env = {"REQUEST_METHOD": method, "PATH_INFO": path,
           "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    got = {}

    def start_response(status, headers):
        got["status"] = int(status.split()[0])

    data = b"".join(app(env, start_response))
    return got["status"], json.loads(data)


@pytest.mark.usefixtures("few_torch_threads")
def test_app_slo_and_health_equal_jax_app(monkeypatch):
    # one tick per evaluator (the first request's): the rest are
    # throttled, whatever the two apps' speeds
    monkeypatch.setenv("RTPU_SLO_TICK", "1e9")
    monkeypatch.delenv("RTPU_SLO", raising=False)
    jts = compile_network(generate_city("tiny"), JCompilerParams(
        reach_radius=500.0, osmlr_max_length=200.0))
    pts = TileSet.from_arrays(jts.name, jts.meta.origin_lonlat,
                              {f: getattr(jts, f) for f in _ARRAY_FIELDS})
    ja = jmake_app(jts, JConfig(
        matcher=JMatcherParams(candidate_backend="dense"),
        service=JServiceConfig(datastore_url=URL, batching="combine")),
        transport=lambda u, b: 200)
    pa = make_app(pts, Config(service=ServiceConfig(
        datastore_url=URL, batching="combine")),
        transport=lambda u, b: 200, device="cpu")
    try:
        reqs = [synthesize_probe(jts, seed=s, num_points=30,
                                 gps_sigma=3.0).to_report_json()
                for s in (3, 4)] + [{"uuid": "bad"}]
        for payload in reqs:
            assert _wsgi(ja, "POST", "/report", payload)[0] == \
                _wsgi(pa, "POST", "/report", payload)[0]
        js, jbody = _wsgi(ja, "GET", "/slo")
        ps, pbody = _wsgi(pa, "GET", "/slo")
        assert (ps, pbody) == (js, jbody) and ps == 200
        assert pbody["enabled"] is True and pbody["ticks"] == 1
        assert set(pbody["slos"]) == {s.name for s in slo.DEFAULT_SLOS}
        jh = _wsgi(ja, "GET", "/health")[1]
        ph = _wsgi(pa, "GET", "/health")[1]
        assert ph["slo"] == jh["slo"]
    finally:
        ja.close()
        pa.close()


def test_app_slo_disabled_alike(monkeypatch):
    monkeypatch.setenv("RTPU_SLO", "0")
    jts = compile_network(generate_city("tiny"), JCompilerParams(
        reach_radius=500.0, osmlr_max_length=200.0))
    pts = TileSet.from_arrays(jts.name, jts.meta.origin_lonlat,
                              {f: getattr(jts, f) for f in _ARRAY_FIELDS})
    pa = make_app(pts, Config(service=ServiceConfig(batching="combine")),
                  device="cpu")
    try:
        assert pa.slo is None
        assert _wsgi(pa, "GET", "/slo") == (200, {"enabled": False})
        assert "slo" not in pa.health()
    finally:
        pa.close()
