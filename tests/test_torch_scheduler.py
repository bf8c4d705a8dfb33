"""The port's continuous in-flight batching (reporter_tpu_torch/service/
scheduler.py), held to the contracts of the JAX package's
tests/test_scheduler.py.

A gated stand-in for ``match_many`` holds a batch "on the card" at will,
so each contract is asserted directly: a lone request closes by its
deadline, a full batch by size; batches land on trace-count rungs; up to
``max_inflight_batches`` batches overlap; a uuid in flight defers its
later requests; one bad request fails alone; ``close()`` drains, and the
full admission queue sheds with 503, counted. Every wait is on an event
with a bounded timeout; no test sleeps for a fixed time.

Without a stand-in: the scheduled app's reports equal the sequential
(combine) app's, four threads calling the port's ``match_many`` at once
get the serial records, and the shared counters sum exactly.

This file imports no JAX, so it also runs on the machine with the card
(``--noconftest``), where the ``gpu`` test holds the sweep's launch
counter to the same exact sum.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, fresh_link_sampler)
from reporter_tpu_torch.config import CompilerParams, Config, ServiceConfig
from reporter_tpu_torch.matcher import api as matcher_api
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.matcher.segments import SegmentRecord
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet, synthesize_probe
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.service.scheduler import ServiceOverloaded, _rung
from reporter_tpu_torch.service.server import serve
from reporter_tpu_torch.tiles.compiler import compile_network

WAIT = 10.0        # the bound of every wait on an event (s)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiles():
    return compile_network(
        generate_city("tiny"),
        CompilerParams(reach_radius=500.0, osmlr_max_length=200.0))


def wsgi_call(app, method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])

    data = b"".join(app(environ, start_response))
    return captured["status"], (json.loads(data) if data else None)


class GateMatcher:
    """match_many stand-in: blocks on ``gate`` (held open by default),
    records every call's uuids and trace count, then emits one complete
    SegmentRecord per trace. ``poison`` uuids raise instead."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self._cv = threading.Condition()
        self.calls: list[list[str]] = []      # per call: uuids (incl. pads)
        self.sizes: list[int] = []            # per call: padded trace count
        self.poison: set = set()

    def wait_calls(self, n: int) -> None:
        with self._cv:
            assert self._cv.wait_for(lambda: len(self.sizes) >= n, WAIT), \
                f"fewer than {n} batches dispatched: {self.sizes}"

    def __call__(self, traces):
        with self._cv:
            self.calls.append([t.uuid for t in traces])
            self.sizes.append(len(traces))
            self._cv.notify_all()
        assert self.gate.wait(WAIT), "test gate never released"
        if self.poison & {t.uuid for t in traces}:
            raise RuntimeError("device rejected the batch")
        out = []
        for t in traces:
            t0 = float(t.times[0]) if len(t.times) else 0.0
            t1 = float(t.times[-1]) if len(t.times) else 1.0
            out.append([SegmentRecord(segment_id=7001, way_ids=[1],
                                      start_time=t0,
                                      end_time=max(t1, t0 + 0.5),
                                      length=50.0, internal=False)])
        return out


def _mk_app(tiles, **svc_kw):
    svc_kw.setdefault("batch_close_ms", 20.0)
    app = make_app(tiles, Config(service=ServiceConfig(**svc_kw)),
                   transport=lambda u, b: 200, device="cpu")
    fake = GateMatcher()
    app.matcher.match_many = fake
    return app, fake


def _declined(app, why):
    """An event set once the scheduler thread has looked at its queue and
    held a submission back: ``why`` "deferred" (its uuid is in flight) or
    "depth" (max_inflight_batches batches are in flight)."""
    sched = app.scheduler
    ev = threading.Event()
    orig = sched._try_close_locked

    def held():
        if why == "deferred":
            return any(s.was_deferred for s in sched._queue)
        return sched._queue and sched._inflight >= sched.max_inflight

    def probe():
        out = orig()
        if out[0] is None and held():
            ev.set()
        return out

    sched._try_close_locked = probe
    return ev


def _queued(app, n):
    """Wait (on the scheduler's condition) until ``n`` submissions sit in
    the admission queue."""
    sched = app.scheduler
    with sched._cv:
        assert sched._cv.wait_for(lambda: len(sched._queue) == n, WAIT), \
            f"admission depth never reached {n}"


def _payload(uuid, n=6, t0=0.0):
    return {"uuid": uuid, "trace": [
        {"lat": 37.7749 + 1e-5 * (t0 + i), "lon": -122.4194,
         "time": t0 + float(i)} for i in range(n)]}


def _bg(fn, *args):
    out = {}

    def run():
        try:
            out["result"] = fn(*args)
        except Exception as exc:
            out["error"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    out["thread"] = th
    return out


def _joined(job):
    job["thread"].join(WAIT)
    assert not job["thread"].is_alive(), "request never completed"
    return job


class TestBatchClose:
    def test_lone_request_closes_by_deadline(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=20.0,
                            max_batch_traces=100)
        out = app.report_one(_payload("solo"))
        assert out["segments"]
        assert len(fake.sizes) == 1      # never stuck waiting for peers
        assert app.scheduler.snapshot()["batches"] == 1
        app.close()

    def test_full_batch_closes_by_size(self, tiles):
        # the deadline is 10 s away: completion before it proves the size
        # close fired
        app, fake = _mk_app(tiles, batch_close_ms=10_000.0,
                            max_batch_traces=4)
        t0 = time.monotonic()
        jobs = [_bg(app.report_one, _payload(f"v{i}")) for i in range(4)]
        for j in jobs:
            assert "result" in _joined(j), j.get("error")
        assert time.monotonic() - t0 < 9.0, "closed by deadline, not size"
        assert sum(fake.sizes) >= 4
        assert app.scheduler.snapshot()["submissions"] == 4
        app.close()

    def test_timed_out_drain_fails_queued_not_hangs(self, tiles):
        """close(timeout) returns while a batch is wedged; the submission
        queued behind it resolves with ServiceOverloaded, and the wedged
        batch's client still gets its result once the wedge clears."""
        app, fake = _mk_app(tiles, batch_close_ms=1.0,
                            max_inflight_batches=1)
        fake.gate.clear()                      # wedge the card
        j1 = _bg(app.report_one, _payload("w1"))
        fake.wait_calls(1)
        j2 = _bg(app.report_one, _payload("w2"))   # queued behind it
        _queued(app, 1)
        t0 = time.monotonic()
        app.scheduler.close(timeout=0.3)
        assert time.monotonic() - t0 < 5.0     # bounded, not hung
        assert isinstance(_joined(j2).get("error"), ServiceOverloaded)
        fake.gate.set()                        # the wedge clears late
        assert "result" in _joined(j1), j1.get("error")

    def test_drain_waives_deadline(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=10_000.0,
                            max_batch_traces=100)
        jobs = [_bg(app.report_one, _payload(f"d{i}")) for i in range(2)]
        _queued(app, 2)
        app.close()          # graceful drain: queued work flushes now
        for j in jobs:
            assert "result" in _joined(j), j.get("error")
        # post-drain admissions shed with 503 through the WSGI face
        status, body = wsgi_call(app, "POST", "/report", _payload("late"))
        assert status == 503 and "error" in body


class TestShapeBuckets:
    def test_same_rung_batches_pad_to_one_size(self, tiles):
        """3 and 4 concurrent single-trace requests each pad to the
        4-rung, however admissions raced into batches."""
        app, fake = _mk_app(tiles, batch_close_ms=40.0,
                            max_batch_traces=100, max_inflight_batches=1)
        for n in (3, 4):
            jobs = [_bg(app.report_one, _payload(f"r{n}-{i}"))
                    for i in range(n)]
            for j in jobs:
                assert "result" in _joined(j), j.get("error")
        assert all(s == _rung(s) for s in fake.sizes), fake.sizes
        snap = app.scheduler.snapshot()
        real = 7
        assert snap["padded_traces"] == sum(fake.sizes) - real
        assert sum(snap["padding_by_bucket"].values()) == \
            snap["padded_traces"]
        occ = app.matcher.metrics.snapshot()
        assert occ["sched_batch_occupancy_count"] == len(fake.sizes)
        app.close()

    def test_rung_helper(self):
        assert [_rung(n) for n in (1, 2, 3, 5, 9, 257)] == [
            1, 2, 4, 8, 16, 512]
        assert _rung(5000) == 5000      # beyond the table: as-is


class TestOverlap:
    def test_two_batches_in_flight(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=1.0,
                            max_inflight_batches=2)
        fake.gate.clear()
        j1 = _bg(app.report_one, _payload("a"))
        fake.wait_calls(1)
        j2 = _bg(app.report_one, _payload("b"))
        # the second batch dispatches while the first is still held
        fake.wait_calls(2)
        assert app.scheduler.snapshot()["inflight_batches"] == 2
        fake.gate.set()
        for j in (j1, j2):
            assert "result" in _joined(j), j.get("error")
        hist = app.scheduler.snapshot()["inflight_hist"]
        assert hist.get(2, 0) >= 1          # a dispatch at depth 2
        app.close()

    def test_depth_one_never_two_in_flight(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=1.0,
                            max_inflight_batches=1)
        declined = _declined(app, "depth")
        fake.gate.clear()
        j1 = _bg(app.report_one, _payload("a"))
        fake.wait_calls(1)
        j2 = _bg(app.report_one, _payload("b"))
        assert declined.wait(WAIT)          # looked at b, dispatched nothing
        assert len(fake.sizes) == 1         # the depth bound held
        fake.gate.set()
        for j in (j1, j2):
            assert "result" in _joined(j), j.get("error")
        assert app.scheduler.snapshot()["inflight_hist"] == {1: 2}
        app.close()

    def test_inflight_uuid_defers_second_request(self, tiles):
        """uuid x's second request must not dispatch while x's first
        batch is in flight: its merge would miss the retained tail."""
        app, fake = _mk_app(tiles, batch_close_ms=1.0,
                            max_inflight_batches=2)
        declined = _declined(app, "deferred")
        fake.gate.clear()
        j1 = _bg(app.report_one, _payload("x", n=6))
        fake.wait_calls(1)
        j2 = _bg(app.report_one, _payload("x", n=6, t0=6.0))
        assert declined.wait(WAIT)
        assert len(fake.sizes) == 1         # deferred, not dispatched
        fake.gate.set()
        for j in (j1, j2):
            assert "result" in _joined(j), j.get("error")
        assert len(fake.sizes) == 2
        assert app.scheduler.snapshot()["deferred"] >= 1
        # the deferred request's merge saw the first one's tail (the
        # straddling point before the cut at t1 = 5.5 rides along)
        assert app.stats["points"] > 12 - 6
        app.close()


class TestErrorIsolation:
    def test_poison_fails_alone_co_batched_served(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=10_000.0,
                            max_batch_traces=3)
        fake.poison = {"bad"}
        jobs = {u: _bg(app.report_one, _payload(u))
                for u in ("good1", "bad", "good2")}
        for j in jobs.values():
            _joined(j)
        assert "result" in jobs["good1"] and "result" in jobs["good2"]
        assert isinstance(jobs["bad"].get("error"), RuntimeError)
        assert app.scheduler.snapshot()["isolated_retries"] == 1
        assert len(fake.sizes) == 4        # batched attempt + 3 retries
        app.close()

    def test_lone_failure_owns_its_error(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=5.0)
        fake.poison = {"bad"}
        with pytest.raises(RuntimeError):
            app.report_one(_payload("bad"))
        # no isolation pass for a single-submission batch
        assert app.scheduler.snapshot()["isolated_retries"] == 0
        assert app.report_one(_payload("ok"))["segments"]
        app.close()


class TestAdmissionBound:
    def test_full_queue_sheds_503_counted(self, tiles):
        app, fake = _mk_app(tiles, batch_close_ms=1.0,
                            max_inflight_batches=1,
                            admission_queue_limit=2)
        fake.gate.clear()
        j1 = _bg(app.report_one, _payload("a", n=2))   # in flight
        fake.wait_calls(1)
        j2 = _bg(app.report_one, _payload("b", n=2))   # queued: 1 trace
        _queued(app, 1)
        # 1 trace queued; +2 would pass the limit of 2 ⇒ shed
        status, _ = wsgi_call(app, "POST", "/report_many",
                              {"traces": [_payload("c"), _payload("d")]})
        assert status == 503
        assert app.scheduler.snapshot()["rejected"] == 1
        assert app.stats["errors"] == 1
        fake.gate.set()
        for j in (j1, j2):
            assert "result" in _joined(j), j.get("error")
        app.close()

    def test_oversized_submission_admitted_when_queue_empty(self, tiles):
        app, fake = _mk_app(tiles, admission_queue_limit=1)
        out = app.report_many([_payload("a"), _payload("b")])
        assert len(out) == 2                # never unservable
        app.close()


class TestConfig:
    @pytest.mark.parametrize("kw", [
        {"batching": "magic"}, {"batch_close_ms": 0.0},
        {"max_batch_traces": 0}, {"max_inflight_batches": 0},
        {"admission_queue_limit": 0}], ids=lambda kw: next(iter(kw)))
    def test_validate_rejects_bad_knobs(self, kw):
        with pytest.raises(ValueError):
            Config(service=ServiceConfig(**kw)).validate()

    def test_for_mode_passes_scheduler_knobs_through(self):
        cfg = Config.for_mode(
            "bicycle",
            service=ServiceConfig(batch_close_ms=9.0,
                                  max_inflight_batches=3,
                                  batching="scheduler"))
        assert cfg.service.mode == "bicycle"
        assert cfg.service.batch_close_ms == 9.0
        assert cfg.service.max_inflight_batches == 3
        assert cfg.matcher.search_radius == 40.0

    def test_env_overrides(self):
        svc = ServiceConfig().with_env_overrides({
            "REPORTER_BATCHING": "combine",
            "REPORTER_BATCH_CLOSE_MS": "12.5",
            "REPORTER_MAX_INFLIGHT": "4"})
        assert svc.batching == "combine"
        assert svc.batch_close_ms == 12.5
        assert svc.max_inflight_batches == 4

    def test_json_roundtrip_keeps_knobs(self):
        c = Config(service=ServiceConfig(batching="combine",
                                         batch_close_ms=7.5,
                                         max_batch_traces=64,
                                         max_inflight_batches=3,
                                         admission_queue_limit=99))
        assert Config.from_json(c.to_json()) == c


class TestParity:
    def test_scheduled_reports_equal_sequential(self, tiles):
        """Report JSON through the scheduler (padding and concurrent batch
        assembly included) equals the sequential combine path's, and the
        counters credit real traces only."""
        payloads = []
        for i in range(9):
            p = synthesize_probe(tiles, seed=60 + i, num_points=40,
                                 gps_sigma=3.0).to_report_json()
            p["uuid"] = f"par-{i}"
            payloads.append(p)
        seq = make_app(tiles, Config(service=ServiceConfig(
            batching="combine")), transport=lambda u, b: 200, device="cpu")
        expected = [seq.report_one(p) for p in payloads]
        sched = make_app(tiles, Config(service=ServiceConfig(
            batching="scheduler", batch_close_ms=5.0)),
            transport=lambda u, b: 200, device="cpu")
        jobs = [_bg(sched.report_one, p) for p in payloads]
        got = [_joined(j).get("result") for j in jobs]
        assert [json.dumps(g, sort_keys=True) for g in got] == \
               [json.dumps(e, sort_keys=True) for e in expected]
        assert sched.scheduler.snapshot()["submissions"] == 9
        assert sched.matcher.metrics.value("traces") == 9.0
        assert sched.matcher.metrics.value("probes") == 9.0 * 40
        sched.close()
        seq.close()


class _ThreadClock:
    """A perf_counter that advances by 1.0 per call, per thread: a stage's
    measured time is then the number of clock reads inside it on its own
    thread, whatever other threads do, so concurrent and serial calls
    measure the same times and their sums are exact."""

    def __init__(self):
        self._tl = threading.local()

    def perf_counter(self):
        n = getattr(self._tl, "n", 0.0) + 1.0
        self._tl.n = n
        return n


def _fleet_traces(ts, n=16, seed=3):
    return [Trace(p.uuid, p.xy.astype(np.float32), p.times)
            for p in synthesize_fleet(ts, n, num_points=60, seed=seed)]


def _run_threads(fn, n):
    out, errs = [None] * n, []
    start = threading.Barrier(n)

    def run(i):
        try:
            start.wait(WAIT)
            out[i] = fn()
        except Exception as exc:      # pragma: no cover
            errs.append(exc)

    ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60.0)
        assert not t.is_alive()
    assert not errs, errs
    return out


def _records(batch):
    return [[r.to_json() for r in x] for x in batch]


def _concurrent_match_many(ts, device, monkeypatch):
    """4 threads call match_many at once on one matcher; → (serial
    records, the four threads' records, the counters after one serial
    call, after the four)."""
    monkeypatch.setattr(matcher_api, "time", _ThreadClock())
    traces = _fleet_traces(ts)
    m = SegmentMatcher(ts, Config(), device=device)
    serial = _run_threads(lambda: m.match_many(traces), 1)[0]
    one = (dict(m.stage_seconds), dict(m.point_counts))
    m.stage_seconds = dict.fromkeys(m.stage_seconds, 0.0)
    m.point_counts = dict.fromkeys(m.point_counts, 0)
    got = _run_threads(lambda: m.match_many(traces), 4)
    return m, serial, got, one, (dict(m.stage_seconds),
                                 dict(m.point_counts))


def test_concurrent_match_many_equals_serial_and_sums(tiles, monkeypatch):
    """No stand-in: four concurrent match_many calls on the CPU give the
    serial records, and stage_seconds and point_counts are exactly four
    times one serial call's."""
    m, serial, got, one, four = _concurrent_match_many(tiles, "cpu",
                                                       monkeypatch)
    want = _records(serial)
    assert all(_records(g) == want for g in got)
    assert four[1] == {k: 4 * v for k, v in one[1].items()}
    assert four[0] == {k: 4 * v for k, v in one[0].items()}
    assert one[0]["wall"] > 0 and one[1]["points"] == 16 * 60
    assert m.metrics.value("traces") == 5 * 16


@pytest.mark.gpu
def test_concurrent_match_many_sums_sweep_launches_on_card(tiles,
                                                           monkeypatch):
    """On the card: the same, and the sweep's launch counter sums exactly
    (one launch of the served instance per wire entry and call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU form")
    monkeypatch.setenv("RTPU_SWEEP_AUTOTUNE", "0")
    for key in dc.SWEEP_LAUNCHES:
        dc.SWEEP_LAUNCHES[key] = 0
    m, serial, got, one, four = _concurrent_match_many(tiles, "cuda",
                                                       monkeypatch)
    launches = dict(dc.SWEEP_LAUNCHES)
    want = _records(serial)
    assert all(_records(g) == want for g in got)
    assert four[1] == {k: 4 * v for k, v in one[1].items()}
    assert four[0] == {k: 4 * v for k, v in one[0].items()}
    assert launches[("sub", 8)] == 5 * len(m.plan_submit(
        _fleet_traces(tiles))[1])
    assert sum(launches.values()) == launches[("sub", 8)]


class TestHealthSurface:
    def test_health_exposes_scheduler_state(self, tiles, fresh_link_sampler):
        app, fake = _mk_app(tiles)
        app.report_one(_payload("h"))
        status, body = wsgi_call(app, "GET", "/health")
        assert status == 200
        s = body["scheduler"]
        assert s["batches"] >= 1 and s["submissions"] >= 1
        assert s["inflight_batches"] == 0
        assert s["admission_depth"] == 0
        assert "inflight_hist" in s and "padding_by_bucket" in s
        assert body["backend"] == "torch" and body["device"] == "cpu"
        # the JAX app's link-health block (utils/linkhealth.py): on a CPU
        # app no host-card path, so no reading
        assert set(body["link"]) == {"mood", "rtt_ms", "mbps",
                                     "probe_duty_pct"}
        assert body["link"]["mood"] in (None, "cpu")
        assert body["link"]["rtt_ms"] is None and body["link"]["mbps"] is None
        assert set(body["slo"]) == {"enabled", "alerting", "alerts_total",
                                    "budget_remaining"}
        app.close()

    def test_combine_mode_has_no_scheduler_block(self, tiles):
        app = make_app(tiles, Config(service=ServiceConfig(
            batching="combine")), transport=lambda u, b: 200, device="cpu")
        assert app.scheduler is None
        assert "scheduler" not in app.health()
        app.close()                          # no-op drain, must not raise


def _post(url, payload, timeout=WAIT):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_threaded_server_on_an_ephemeral_port(tiles):
    """serve() binds 127.0.0.1:0; real HTTP requests get the app's
    responses; the server always shuts down."""
    app = make_app(tiles, Config(), transport=lambda u, b: 200,
                   device="cpu")
    server = serve(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        p = synthesize_probe(tiles, seed=71, num_points=50,
                             gps_sigma=3.0).to_report_json()
        status, body = _post(base + "/report", p)
        assert status == 200 and body["segments"]
        with urllib.request.urlopen(base + "/metrics", timeout=WAIT) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            assert b"rtpu_match_seconds_bucket" in r.read()
    finally:
        server.shutdown()
        server.server_close()
        app.close()
        th.join(WAIT)


def test_threaded_server_takes_64_clients_at_once(tiles):
    """64 clients connecting together all get 200: the listen backlog
    holds them (socketserver's default of 5 resets connections)."""
    app, fake = _mk_app(tiles, batch_close_ms=5.0)
    server = serve(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    n = 64
    start = threading.Barrier(n)
    url = f"http://127.0.0.1:{server.server_address[1]}/report"

    def one(i):
        start.wait(WAIT)
        return _post(url, _payload(f"c{i}"))[0]

    try:
        jobs = [_bg(one, i) for i in range(n)]
        assert [_joined(j).get("result") for j in jobs] == [200] * n, \
            [j.get("error") for j in jobs if "error" in j][:3]
        assert app.scheduler.snapshot()["submissions"] == n
    finally:
        server.shutdown()
        server.server_close()
        app.close()
        th.join(WAIT)


def _server(tmp_path, path, *flags):
    """python -m reporter_tpu_torch.service.server --device cpu over the
    tile at ``path`` as a subprocess, started with ``flags``. → (the
    process, its port, the reader thread, its stderr lines)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "reporter_tpu_torch.service.server",
         "--tiles", path, "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", *flags], cwd=str(tmp_path), env=env,
        stderr=subprocess.PIPE, text=True)
    ready, lines = threading.Event(), []

    def read():
        for ln in proc.stderr:
            lines.append(ln)
            if " serving " in ln:
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    if not ready.wait(60.0):
        proc.kill()
        proc.wait(WAIT)
        raise AssertionError("".join(lines))
    port = int(next(ln for ln in lines if " serving " in ln)
               .split(" on 127.0.0.1:")[1].split(",")[0])
    return proc, port, reader, lines


def _drain(proc, reader, lines):
    """SIGINT drains the server to exit code 0."""
    import signal

    proc.send_signal(signal.SIGINT)
    assert proc.wait(WAIT) == 0
    reader.join(WAIT)
    assert any("draining scheduler" in ln for ln in lines)


def test_server_entry_point_serves_and_drains_on_sigint(tiles, tmp_path):
    """python -m reporter_tpu_torch.service.server --device cpu on a saved
    tile: it answers /report like an in-process app, and SIGINT drains it
    to exit code 0."""
    path = tiles.save(str(tmp_path / "tiny"))
    proc, port, reader, lines = _server(tmp_path, path)
    try:
        p = synthesize_probe(tiles, seed=72, num_points=50,
                             gps_sigma=3.0).to_report_json()
        status, body = _post(f"http://127.0.0.1:{port}/report", p)
        ref = make_app(tiles, Config(), device="cpu")
        assert status == 200 and body == ref.report_one(p)
        ref.close()
        _drain(proc, reader, lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(WAIT)


@pytest.mark.parametrize("flags", [
    ["--mode", "bicycle"], ["--tiles", "a.npz", "b.npz"]],
    ids=["mode", "tiles"])
def test_server_flags_not_ported_raise(flags, tiles, tmp_path, monkeypatch):
    """Flags that were once refusals. --mode bicycle starts the server
    tagged "bicycle" with the bicycle preset: its answers equal an
    in-process ``Config.for_mode("bicycle")`` app's, carry mode "bicycle",
    and a request naming another mode gets 400. Several --tiles start the
    metro router over every tile."""
    from reporter_tpu_torch.service import server
    from reporter_tpu_torch.service.router import MetroRouter
    from reporter_tpu_torch.tiles.tileset import TileSet

    if flags[0] == "--mode":
        path = tiles.save(str(tmp_path / "tiny"))
        proc, port, reader, lines = _server(tmp_path, path, *flags)
        try:
            p = synthesize_probe(tiles, seed=73, num_points=50,
                                 gps_sigma=3.0).to_report_json()
            url = f"http://127.0.0.1:{port}/report"
            status, body = _post(url, p)
            ref = make_app(tiles, Config.for_mode("bicycle"), device="cpu")
            assert status == 200 and body["mode"] == "bicycle"
            assert body == ref.report_one(p)
            ref.close()
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, dict(p, mode="auto"))
            assert err.value.code == 400
            _drain(proc, reader, lines)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(WAIT)
        return
    names = []
    for i, f in enumerate(flags[1:]):
        ts = TileSet.from_arrays(f"metro{i}", tiles.meta.origin_lonlat,
                                 tiles.arrays())
        names.append(ts.name)
        ts.save(str(tmp_path / f))
    served = {}

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            served["closed"] = True

    def fake_serve(app, host, port):
        served["app"] = app
        return _Server()

    monkeypatch.setattr(server, "serve", fake_serve)
    monkeypatch.setenv("RTPU_LINK_PROBE", "0")
    server.main(["--tiles", *(str(tmp_path / f) for f in flags[1:]),
                 "--device", "cpu"])
    assert isinstance(served["app"], MetroRouter)
    assert sorted(served["app"].apps) == names and served["closed"]
