"""The port's report service (reporter_tpu_torch/service/) against the JAX
package's, on the CPU.

Parity, tolerance 0: the same request streams, built with numpy from a
seed, go through the JAX ``make_app`` (dense candidates: on a CPU backend
"auto" would take the grid backend) and the port's ``make_app(...,
device="cpu")`` on the same tile arrays; the responses (status and JSON)
and the datastore bodies, captured by a ``transport=`` function, must be
equal. Streams: single reports, a trace split over three requests, a
duplicate uuid within one ``/report_many``, and bad payloads among good
ones.

Then the JAX package's endpoint, cache and report-builder tests
(tests/test_service.py) on the port's modules, the config JSON written by
the JAX package, the shared tile file, the publisher's real urllib
transport, and each unported config field raising.
"""

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.service.app import make_app as jmake_app
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from reporter_tpu.tiles.tileset import TileSet as JTileSet
from reporter_tpu_torch.config import (CompilerParams, Config, MatcherParams,
                                       ServiceConfig)
from reporter_tpu_torch.matcher.api import SegmentMatcher
from reporter_tpu_torch.matcher.segments import SegmentRecord
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.service.cache import PartialTraceCache
from reporter_tpu_torch.service.datastore import DatastorePublisher
from reporter_tpu_torch.service.reports import build_reports
from reporter_tpu_torch.tiles.tileset import TileSet
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

URL = "http://datastore.test/"


def wsgi_call(app, method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])
        captured["headers"] = dict(headers)

    data = b"".join(app(environ, start_response))
    if captured["headers"]["Content-Type"].startswith("text/plain"):
        return captured["status"], data.decode()
    return captured["status"], (json.loads(data) if data else None)


@pytest.fixture(scope="module")
def svc_tiles():
    """The JAX package's tile (tests/test_service.py's fixture): short
    OSMLR segments (~200 m), so full traversals are common."""
    return compile_network(
        generate_city("tiny"),
        JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0))


@pytest.fixture(scope="module")
def port_tiles(svc_tiles):
    return TileSet.from_arrays(svc_tiles.name, svc_tiles.meta.origin_lonlat,
                               {f: getattr(svc_tiles, f)
                                for f in _ARRAY_FIELDS})


def _capture():
    bodies = []

    def transport(url, body):
        assert url == URL
        bodies.append(json.loads(body))
        return 200

    return bodies, transport


def _pair(svc_tiles, port_tiles, **svc_kw):
    """(JAX app, port app, JAX datastore bodies, port datastore bodies)."""
    jb, jt = _capture()
    pb, pt = _capture()
    ja = jmake_app(svc_tiles, JConfig(
        matcher=JMatcherParams(candidate_backend="dense"),
        service=JServiceConfig(datastore_url=URL, **svc_kw)), transport=jt)
    pa = make_app(port_tiles, Config(
        service=ServiceConfig(datastore_url=URL, **svc_kw)), transport=pt,
        device="cpu")
    return ja, pa, jb, pb


def _probe(ts, seed, num_points):
    return synthesize_probe(ts, seed=int(seed), num_points=int(num_points),
                            gps_sigma=3.0).to_report_json()


def _stream(name, ts, seed):
    """[(method, path, payload)] of one request stream, from a seed."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 10_000, 8)
    if name == "single":
        out = []
        for i, s in enumerate(seeds[:5]):
            p = _probe(ts, s, rng.integers(30, 160))
            p["uuid"] = f"single-{i}"
            out.append(("POST", "/report", p))
        return out
    if name == "split_three":
        pts = _probe(ts, seeds[0], 180)["trace"]
        cuts = np.sort(rng.choice(np.arange(20, 160), 2, replace=False))
        parts = np.split(np.arange(len(pts)), cuts)
        return [("POST", "/report",
                 {"uuid": "veh", "trace": [pts[i] for i in part]})
                for part in parts]
    if name == "duplicate_uuid":
        pts = _probe(ts, seeds[1], 160)["trace"]
        half = int(rng.integers(40, 120))
        others = [_probe(ts, s, 60) for s in seeds[2:4]]
        return [("POST", "/report_many", {"traces": [
            {"uuid": "dup", "trace": pts[:half]}, others[0],
            {"uuid": "dup", "trace": pts[half:]}, others[1]]}),
            ("POST", "/report", {"uuid": "dup", "trace": pts[-5:]})]
    if name == "bad_among_good":
        good = [_probe(ts, s, 50) for s in seeds[4:7]]
        return [
            ("POST", "/report", good[0]),
            ("POST", "/report", {"uuid": "v", "trace": []}),
            ("POST", "/report_many", {"traces": [
                good[1], {"uuid": "v", "trace": [{"lat": 1}]}]}),
            ("POST", "/report", {"uuid": "v", "trace": [
                {"lat": 1, "lon": 1, "accuracy": -3.0}]}),
            ("POST", "/report_many", {"traces": "nope"}),
            ("POST", "/report_many", {"traces": [good[1], good[2]]}),
            ("GET", "/report", None),
            ("POST", "/report", good[2])]
    raise ValueError(name)


STREAMS = ("single", "split_three", "duplicate_uuid", "bad_among_good")


@pytest.mark.parametrize("batching", ["scheduler", "combine"])
@pytest.mark.parametrize("name", STREAMS)
def test_app_parity_with_jax(svc_tiles, port_tiles, name, batching):
    """Every response and every datastore body equal (tolerance 0)."""
    ja, pa, jb, pb = _pair(svc_tiles, port_tiles, batching=batching)
    try:
        for method, path, payload in _stream(name, svc_tiles, seed=7):
            want = wsgi_call(ja, method, path, payload)
            got = wsgi_call(pa, method, path, payload)
            assert got == want, (method, path)
        assert pb == jb
        assert jb, "the stream published nothing"
        assert {k: v for k, v in pa.stats.items() if k != "match_seconds"} \
            == {k: v for k, v in ja.stats.items() if k != "match_seconds"}
    finally:
        ja.close()
        pa.close()


@pytest.fixture(scope="module")
def app(port_tiles):
    published = []

    def transport(url, body):
        published.append(json.loads(body))
        return 200

    a = make_app(port_tiles, Config(service=ServiceConfig(
        datastore_url=URL)), transport=transport, device="cpu")
    a.test_published = published
    yield a
    a.close()


class TestEndpoints:
    def test_health(self, app):
        status, body = wsgi_call(app, "GET", "/health")
        assert status == 200
        assert body["status"] == "ok"
        assert body["edges"] == app.matcher.ts.num_edges
        assert body["backend"] == "torch" and body["device"] == "cpu"
        assert body["tile_hbm_bytes"] == sum(
            t.numel() * t.element_size()
            for t in app.matcher.tables.values())
        assert set(body["quality"]) >= {"enabled", "window_waves",
                                        "drifted", "empty_match_rate"}

    def test_stats_endpoint(self, app, svc_tiles):
        payload = _probe(svc_tiles, 23, 120)
        wsgi_call(app, "POST", "/report", payload)
        status, body = wsgi_call(app, "GET", "/stats")
        assert status == 200
        assert body["probes"] >= len(payload["trace"])
        assert body["match_seconds_count"] >= 1
        assert body["match_seconds_p50"] > 0
        assert "uptime_seconds" in body

    def test_metrics_endpoint(self, app, svc_tiles):
        wsgi_call(app, "POST", "/report", _probe(svc_tiles, 24, 60))
        status, text = wsgi_call(app, "GET", "/metrics")
        assert status == 200
        assert "# TYPE rtpu_match_seconds histogram" in text
        assert 'rtpu_match_seconds_bucket{le="+Inf"}' in text
        assert 'rtpu_quality_batches{metro="tiny"}' in text
        assert "rtpu_http_requests" in text

    def test_report_roundtrip(self, app, svc_tiles):
        status, body = wsgi_call(app, "POST", "/report",
                                 _probe(svc_tiles, 11, 120))
        assert status == 200
        assert body["mode"] == "auto"
        assert len(body["segments"]) > 0
        assert len(body["reports"]) > 0
        for r in body["reports"]:
            assert r["t1"] > r["t0"]
            assert r["length"] > 0
            assert r["id"] >= 0

    def test_reports_published_to_datastore(self, app, svc_tiles):
        before = app.publisher.published
        _, body = wsgi_call(app, "POST", "/report", _probe(svc_tiles, 12, 120))
        assert app.publisher.published == before + len(body["reports"])
        last = app.test_published[-1]
        assert last["mode"] == "auto"
        assert {"id", "next_id", "t0", "t1", "length", "queue_length"} <= set(
            last["reports"][0])

    def test_publish_json_failures_counted(self):
        def bad_transport(url, body):
            raise OSError("connection refused")

        pub = DatastorePublisher(url=URL, transport=bad_transport)
        assert pub.publish_json({"histograms": []}) is False
        assert pub.json_failures == 1
        pub2 = DatastorePublisher(url=URL, transport=lambda u, b: 503)
        assert pub2.publish_json({"histograms": []}) is False
        assert pub2.json_failures == 1
        pub3 = DatastorePublisher(url=URL, transport=lambda u, b: 200)
        assert pub3.publish_json({"histograms": []}) is True
        assert pub3.json_failures == 0

    def test_next_segment_chaining(self, app, svc_tiles):
        _, body = wsgi_call(app, "POST", "/report", _probe(svc_tiles, 13, 200))
        reports = body["reports"]
        assert len(reports) >= 2
        assert any(r["next_id"] is not None for r in reports[:-1])
        for a, b in zip(reports, reports[1:]):
            if a["next_id"] is not None:
                assert a["next_id"] == b["id"]

    def test_report_many_batches(self, app, svc_tiles):
        payloads = [_probe(svc_tiles, 20 + i, 120) for i in range(3)]
        status, body = wsgi_call(app, "POST", "/report_many",
                                 {"traces": payloads})
        assert status == 200
        assert len(body["results"]) == 3
        assert all(len(r["segments"]) > 0 for r in body["results"])

    @pytest.mark.parametrize("method,path,payload,want", [
        ("POST", "/report", None, 400),                       # empty body
        ("POST", "/report", {"trace": [{"lat": 0, "lon": 0}]}, 400),  # no uuid
        ("POST", "/report", {"uuid": "v", "trace": []}, 400),  # empty trace
        ("POST", "/report", {"uuid": "v", "trace": [{"lat": 1}]}, 400),
        ("POST", "/report", {"uuid": "v", "trace": [
            {"lat": 1, "lon": 1, "accuracy": "25m"}]}, 400),  # non-numeric
        ("POST", "/report", {"uuid": "v", "trace": [
            {"lat": 1, "lon": 1, "accuracy": float("nan")}]}, 400),  # NaN
        ("POST", "/report", {"uuid": "v", "trace": [
            {"lat": 1, "lon": 1, "accuracy": -3.0}]}, 400),   # negative
        ("GET", "/report", None, 405),
        ("POST", "/nope", {"x": 1}, 404),
        ("GET", "/aggregates", None, 404),                    # none wired
    ])
    def test_bad_requests(self, app, method, path, payload, want):
        status, _ = wsgi_call(app, method, path, payload)
        assert status == want


class TestCacheContinuation:
    def test_split_trace_completes_segments(self, port_tiles, svc_tiles):
        """A traversal split across two /report calls is completed by the
        per-uuid cache."""
        app_split = make_app(port_tiles, Config(), device="cpu")
        app_whole = make_app(port_tiles, Config(), device="cpu")
        payload = _probe(svc_tiles, 31, 160)
        pts = payload["trace"]
        half = len(pts) // 2
        whole = wsgi_call(app_whole, "POST", "/report", payload)[1]
        first = wsgi_call(app_split, "POST", "/report",
                          {"uuid": "v", "trace": pts[:half]})[1]
        second = wsgi_call(app_split, "POST", "/report",
                           {"uuid": "v", "trace": pts[half:]})[1]
        ids_whole = [r["id"] for r in whole["reports"]]
        ids_split = [r["id"] for r in first["reports"]] + [
            r["id"] for r in second["reports"]]
        assert set(ids_whole) <= set(ids_split)
        app_split.close()
        app_whole.close()

    def test_duplicate_uuid_in_one_batch(self, port_tiles, svc_tiles):
        """Two halves of one trace under one uuid inside a single
        /report_many behave as if they arrived sequentially."""
        payload = _probe(svc_tiles, 31, 160)
        pts = payload["trace"]
        half = len(pts) // 2
        app = make_app(port_tiles, Config(), device="cpu")
        whole = app.report_one(payload)
        app2 = make_app(port_tiles, Config(), device="cpu")
        results = app2.report_many([{"uuid": "v", "trace": pts[:half]},
                                    {"uuid": "v", "trace": pts[half:]}])
        ids_whole = {r["id"] for r in whole["reports"]}
        ids_batch = {r["id"] for res in results for r in res["reports"]}
        assert ids_whole <= ids_batch
        app.close()
        app2.close()

    def test_cache_is_dropped_after_completion(self, port_tiles, svc_tiles):
        app = make_app(port_tiles, Config(), device="cpu")
        wsgi_call(app, "POST", "/report", _probe(svc_tiles, 32, 120))
        assert len(app.cache) <= 1
        app.close()


class TestPartialTraceCache:
    def test_merge_dedupes_and_sorts(self):
        c = PartialTraceCache(ttl=60)
        c.retain("v", [{"lat": 0, "lon": 0, "time": 1.0},
                       {"lat": 0, "lon": 0, "time": 2.0}], from_time=0.0)
        merged = c.merge("v", [{"lat": 0, "lon": 0, "time": 2.0},
                               {"lat": 0, "lon": 0, "time": 3.0}])
        assert [p["time"] for p in merged] == [1.0, 2.0, 3.0]

    def test_ttl_eviction_with_fake_clock(self):
        now = [0.0]
        c = PartialTraceCache(ttl=10.0, clock=lambda: now[0])
        c.retain("v", [{"lat": 0, "lon": 0, "time": 1.0}], from_time=0.0)
        assert len(c) == 1
        now[0] = 11.0
        assert c.merge("v", []) == []          # evicted on access
        assert len(c) == 0

    def test_lru_bound(self):
        c = PartialTraceCache(ttl=1e9, max_uuids=2)
        for i in range(4):
            c.retain(f"v{i}", [{"lat": 0, "lon": 0, "time": 1.0}], 0.0)
        assert len(c) == 2
        assert c.merge("v3", []) != []
        assert c.merge("v0", []) == []

    def test_straddling_point_retained_and_checkpoint(self):
        now = [100.0]
        c = PartialTraceCache(ttl=30.0, clock=lambda: now[0])
        pts = [{"lat": 0, "lon": 0, "time": float(t)} for t in range(6)]
        c.retain("v", pts, from_time=3.5)     # keeps t=3 (straddles) on
        assert [p["time"] for p in c.merge("v", [])] == [3.0, 4.0, 5.0]
        now[0] = 110.0
        snap = c.dump()
        assert snap["v"]["age"] == 10.0
        d = PartialTraceCache(ttl=30.0, clock=lambda: 0.0)
        d.load(snap, extra_age=25.0)          # 35 s old: past the TTL
        assert len(d) == 0
        d.load(snap)
        assert [p["time"] for p in d.merge("v", [])] == [3.0, 4.0, 5.0]


class TestReportBuilder:
    def _rec(self, sid, t0, t1, internal=False, length=100.0):
        return SegmentRecord(segment_id=sid, way_ids=[1], start_time=t0,
                             end_time=t1, length=length, internal=internal)

    def test_filters_partial_and_internal(self):
        recs = [
            self._rec(1, 0.0, 10.0),
            self._rec(2, 10.0, -1.0),          # exit unobserved → dropped
            self._rec(-1, 3.0, 4.0, internal=True),
            self._rec(3, -1.0, 20.0),          # entry unobserved → dropped
        ]
        assert [r.segment_id for r in build_reports(recs)] == [1]

    def test_min_length(self):
        recs = [self._rec(1, 0.0, 10.0, length=5.0)]
        assert build_reports(recs, min_length=10.0) == []
        assert len(build_reports(recs, min_length=1.0)) == 1

    def test_chaining_across_internal_connector(self):
        recs = [self._rec(1, 0.0, 10.0),
                self._rec(-1, 10.0, 12.0, internal=True),
                self._rec(2, 12.0, 20.0)]
        assert build_reports(recs)[0].next_segment_id == 2

    def test_partial_record_breaks_chain(self):
        recs = [self._rec(1, 0.0, 10.0),
                self._rec(2, 10.0, -1.0),
                self._rec(3, 10.0, 20.0)]
        assert build_reports(recs)[0].next_segment_id is None

    def test_chaining_requires_contiguity(self):
        recs = [self._rec(1, 0.0, 10.0), self._rec(2, 10.0, 20.0),
                self._rec(3, 25.0, 30.0)]     # gap 20→25 breaks the chain
        reports = build_reports(recs)
        assert reports[0].next_segment_id == 2
        assert reports[1].next_segment_id is None
        assert reports[2].next_segment_id is None


def test_config_json_written_by_jax_reads_in_the_port():
    """The JAX package's to_json, read by the port: the same matcher,
    compiler, service and streaming sections, and the port's own round
    trip."""
    jc = JConfig(
        matcher=JMatcherParams(search_radius=42.0, max_candidates=6,
                               sweep_lowp="bf16"),
        service=JServiceConfig(datastore_url="http://x/", cache_ttl=12.0,
                               batch_close_ms=7.5, publish_retries=2,
                               dead_letter_dir="/spool"),
        streaming=JStreamingConfig(hist_flush_interval=7.0,
                                   num_partitions=3))
    pc = Config.from_json(jc.to_json())
    for section in ("matcher", "compiler", "service", "streaming"):
        jd = json.loads(jc.to_json())[section]
        assert json.loads(pc.to_json())[section] == jd, section
    assert pc.streaming.num_partitions == 3
    assert pc.matcher_backend == "torch"
    assert pc.validate() is pc
    assert Config.from_json(pc.to_json()) == pc


@pytest.mark.parametrize("make,item", [
    (lambda: MatcherParams(dispatch_timeout_s=2.0),
     lambda p: p.dispatch_timeout_s == 2.0),
    (lambda: MatcherParams(dispatch_fallback="reference_cpu"),
     lambda p: p.dispatch_fallback == "reference_cpu"),
    (lambda: MatcherParams(candidate_backend="grid"), "item 5"),
    (lambda: CompilerParams(cell_size=32.0), "item 5"),
    (lambda: Config(matcher_backend="reference_cpu").validate(),
     lambda c: c.matcher_backend == "reference_cpu"),
    (lambda: Config.for_mode("foot").validate(),
     lambda c: c.service.mode == "foot"
     and c.matcher == MatcherParams.preset("foot")),
    (lambda: MatcherParams().with_env_overrides(
        {"RTPU_DISPATCH_TIMEOUT_S": "5"}),
     lambda p: p.dispatch_timeout_s == 5.0),
    (lambda: Config.from_json(JConfig(matcher=JMatcherParams(
        dispatch_timeout_s=1.0)).to_json()),
     lambda c: c.matcher.dispatch_timeout_s == 1.0),
], ids=["timeout", "fallback", "grid", "grid_compiler", "oracle", "mode",
        "timeout_env", "timeout_json"])
def test_unported_fields_raise_naming_the_roadmap_item(make, item):
    """A field whose feature is not ported raises naming its ROADMAP
    item. The dispatch watchdog, its fallback, the oracle and per-mode
    serving have been ported since: their cases (``item`` a check) now
    hold the field as given."""
    if callable(item):
        assert item(make())
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        make()


def test_tile_file_saved_by_jax_loads_in_the_port(svc_tiles, tmp_path):
    """A TileSet the JAX package saved loads in the port with equal
    arrays, staged tables and records; the port's save loads in both."""
    path = str(tmp_path / "tiny.npz")
    svc_tiles.save(path)
    ts = TileSet.load(path)
    assert ts.name == svc_tiles.name and ts.stats == svc_tiles.stats
    assert ts.meta.origin_lonlat == tuple(svc_tiles.meta.origin_lonlat)
    for f, a in ts.arrays().items():
        b = getattr(svc_tiles, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    ref = TileSet.from_arrays(
        svc_tiles.name, svc_tiles.meta.origin_lonlat,
        {f: getattr(svc_tiles, f) for f in ts.arrays()})
    pm, rm = (SegmentMatcher(t, device="cpu") for t in (ts, ref))
    for k, v in pm.tables.items():       # bytes equal (the pack holds NaN)
        assert v.numpy().tobytes() == rm.tables[k].numpy().tobytes(), k
    payload = _probe(svc_tiles, 5, 120)
    assert pm.match(payload) == rm.match(payload)
    back = ts.save(str(tmp_path / "port"))
    again = JTileSet.load(back)
    assert again.num_edges == svc_tiles.num_edges
    assert np.array_equal(again.reach_to, svc_tiles.reach_to)
    assert TileSet.load(back).arrays().keys() == ts.arrays().keys()


def test_tile_file_schema_and_restrictions_raise(svc_tiles, tmp_path):
    """An old schema still raises. A turn-restricted tile the JAX package
    saved no longer does: it loads with its banned pairs and private rows,
    and the port's app answers as the JAX app does."""
    path = str(tmp_path / "t.npz")
    svc_tiles.save(path)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["_meta"]).decode())
    bad = dict(arrays, _meta=np.frombuffer(
        json.dumps(dict(meta, schema=3)).encode(), dtype=np.uint8))
    np.savez(str(tmp_path / "old.npz"), **bad)
    with pytest.raises(ValueError, match="schema 3"):
        TileSet.load(str(tmp_path / "old.npz"))
    from reporter_tpu.netgen.synthetic import add_random_restrictions

    jts = compile_network(add_random_restrictions(generate_city("tiny")),
                          JCompilerParams(reach_radius=500.0,
                                          osmlr_max_length=200.0))
    jts.save(str(tmp_path / "ban.npz"))
    ts = TileSet.load(str(tmp_path / "ban.npz"))
    assert ts.ban_set == jts.ban_set and len(ts.ban_set)
    assert len(ts.reach_to) > ts.num_nodes
    for f, a in ts.arrays().items():
        assert np.array_equal(a, getattr(jts, f)), f
    japp = jmake_app(jts, JConfig())
    app = make_app(ts, Config(), device="cpu")
    try:
        for seed in (3, 4):
            p = synthesize_probe(jts, seed=seed, num_points=60,
                                 gps_sigma=3.0).to_report_json()
            assert app.report_one(p) == japp.report_one(p)
    finally:
        japp.close()
        app.close()


class _Sink(BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.bodies.append(json.loads(body))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


def test_publisher_urllib_transport_reaches_a_local_datastore(
        svc_tiles, port_tiles):
    """DATASTORE_URL through the publisher's real urllib transport to a
    local HTTP server: the bodies the JAX app's capture sees."""
    sink = HTTPServer(("127.0.0.1", 0), _Sink)
    sink.bodies = []
    th = threading.Thread(target=sink.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{sink.server_address[1]}/store"
        pa = make_app(port_tiles, Config(service=ServiceConfig(
            datastore_url=url)), device="cpu")
        jb = []
        ja = jmake_app(svc_tiles, JConfig(
            matcher=JMatcherParams(candidate_backend="dense"),
            service=JServiceConfig(datastore_url=url)),
            transport=lambda u, b: jb.append(json.loads(b)) or 200)
        for s in (41, 42):
            p = _probe(svc_tiles, s, 120)
            assert pa.report_one(p) == ja.report_one(p)
        assert sink.bodies == jb and jb
        assert pa.publisher.published == sum(len(b["reports"]) for b in jb)
        pa.close()
        ja.close()
    finally:
        sink.shutdown()
        sink.server_close()
        th.join(10.0)
