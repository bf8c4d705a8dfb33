"""The port's metro router (reporter_tpu_torch/service/router.py) against
the JAX package's, on the CPU.

Parity, tolerance 0: two metros compiled by the JAX package at well
separated centres (tests/test_service.py's TestMetroRouter), the JAX
``make_router`` (dense candidates: on a CPU backend "auto" would take the
grid backend) and the port's ``make_router(..., device="cpu")`` over the
same tile arrays; the same requests, built with numpy from a seed, give
equal responses, status codes and datastore bodies (captured by a
``transport=`` function): routing by location, the explicit ``"metro"``
field, ``report_many`` order, a trace outside every metro (404 with
``known_metros``, counted in ``router_unroutable``), an unknown metro
(400), and the WSGI ``/health``, ``/report``, ``/stats`` and
``/metrics``. The dilated boxes are equal in float64, so a point on a
box's edge routes alike; nested metros route to the most specific in
either order. Then the server entry point with several ``--tiles``.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.service.router import make_router as jmake_router
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from reporter_tpu_torch.config import Config, ServiceConfig
from reporter_tpu_torch.service.app import BadRequest
from reporter_tpu_torch.service.router import (MetroRouter, UnroutableTrace,
                                               make_router)
from reporter_tpu_torch.tiles.tileset import TileSet
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

URL = "http://datastore.test/"
WAIT = 60.0


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


def _port(jts):
    return TileSet.from_arrays(jts.name, jts.meta.origin_lonlat,
                               {f: getattr(jts, f) for f in _ARRAY_FIELDS})


def _capture():
    bodies = []

    def transport(url, body):
        assert url == URL
        bodies.append(json.loads(body))
        return 200

    return bodies, transport


def _pair(jtilesets):
    """(JAX router, port router, JAX bodies, port bodies) over the same
    JAX-compiled tiles."""
    jb, jt = _capture()
    pb, pt = _capture()
    jr = jmake_router(jtilesets, JConfig(
        matcher=JMatcherParams(candidate_backend="dense"),
        service=JServiceConfig(datastore_url=URL)), transport=jt)
    pr = make_router([_port(t) for t in jtilesets], Config(
        service=ServiceConfig(datastore_url=URL)), transport=pt,
        device="cpu")
    return jr, pr, jb, pb


def _probe(ts, seed, num_points=120):
    return synthesize_probe(ts, seed=int(seed), num_points=num_points,
                            gps_sigma=3.0).to_report_json()


@pytest.fixture(scope="module")
def metros():
    """tests/test_service.py's two metros: tiny, and a small nyc."""
    params = JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0)
    a = compile_network(generate_city("tiny"), params)
    b = compile_network(generate_city("nyc", nx=8, ny=8), params)
    return a, b


@pytest.fixture(scope="module")
def routers(metros):
    jr, pr, jb, pb = _pair(list(metros))
    yield jr, pr, jb, pb
    jr.close()
    pr.close()


def _both(routers, method, path, payload=None):
    jr, pr, _, _ = routers
    return (wsgi_call(jr, method, path, payload),
            wsgi_call(pr, method, path, payload))


def test_bounds_equal_the_jax_router_in_float64(routers, metros):
    jr, pr, _, _ = routers
    assert list(pr._bounds) == list(jr._bounds)
    for name, (lo, hi) in jr._bounds.items():
        plo, phi = pr._bounds[name]
        assert plo.dtype == phi.dtype == np.float64
        np.testing.assert_array_equal(plo, lo)
        np.testing.assert_array_equal(phi, hi)
    assert [n for n, _ in pr._by_area] == [n for n, _ in jr._by_area]


def test_routes_by_location(routers, metros):
    jr, pr, jb, pb = routers
    a, b = metros
    for ts, seed in ((a, 5), (b, 6)):
        p = _probe(ts, seed)
        got, want = pr.report_one(p), jr.report_one(p)
        assert got == want
        assert got["metro"] == ts.name
    assert pb == jb


def test_explicit_metro_field_and_report_many_order(routers, metros):
    jr, pr, jb, pb = routers
    a, b = metros
    rng = np.random.default_rng(7)
    s1, s2 = rng.integers(0, 10_000, 2)
    pa = _probe(a, s1)
    pa["metro"] = a.name
    pb_ = _probe(b, s2)
    batch = [pb_, pa, dict(pb_, uuid=pb_["uuid"] + "-2")]
    got = pr.report_many(batch)
    assert got == jr.report_many(batch)
    assert [o["metro"] for o in got] == [b.name, a.name, b.name]
    assert pb == jb


def test_unroutable_and_unknown_metro(routers, metros):
    jr, pr, _, _ = routers
    from reporter_tpu.service.app import BadRequest as JBadRequest

    for r, bad_request in ((jr, JBadRequest), (pr, BadRequest)):
        with pytest.raises(bad_request) as ei:
            r.report_one({"uuid": "x",
                          "trace": [{"lat": -45.0, "lon": 100.0}]})
        assert ei.value.known_metros == sorted(m.name for m in metros)
        with pytest.raises(bad_request, match="unknown metro"):
            r.report_one({"uuid": "x", "metro": "atlantis",
                          "trace": [{"lat": 0, "lon": 0}]})
    assert isinstance(ei.value, UnroutableTrace)
    far = {"uuid": "far", "trace": [{"lat": -45.0, "lon": 100.0}]}
    (js, jbody), (ps, pbody) = _both(routers, "POST", "/report", far)
    assert ps == js == 404
    assert pbody == jbody
    assert pbody["known_metros"] == sorted(m.name for m in metros)
    (js, jbody), (ps, pbody) = _both(
        routers, "POST", "/report_many",
        {"traces": [_probe(metros[0], 11, 20), far]})
    assert ps == js == 404 and pbody == jbody
    (js, jbody), (ps, pbody) = _both(
        routers, "POST", "/report",
        {"uuid": "x", "metro": "atlantis", "trace": [{"lat": 0, "lon": 0}]})
    assert ps == js == 400 and pbody == jbody
    assert pr.metrics.value("router_unroutable") == \
        jr.metrics.value("router_unroutable") >= 3
    (js, jtext), (ps, ptext) = _both(routers, "GET", "/metrics")

    def series(text):       # every line but the registries' uptimes
        return [ln for ln in text.splitlines() if "uptime" not in ln]

    assert ps == js == 200 and series(ptext) == series(jtext)
    assert "rtpu_router_unroutable" in ptext
    for bad in ({"traces": 3}, [1, 2]):
        (js, jbody), (ps, pbody) = _both(routers, "POST", "/report_many",
                                         bad)
        assert ps == js == 400 and pbody == jbody
    (js, _), (ps, _) = _both(routers, "GET", "/report")
    assert ps == js == 405
    (js, _), (ps, _) = _both(routers, "GET", "/nope")
    assert ps == js == 404


def test_a_point_on_a_box_edge_routes_alike(routers):
    from reporter_tpu.service.app import BadRequest as JBadRequest

    jr, pr, _, _ = routers
    for name, (lo, hi) in jr._bounds.items():
        for lon, lat in ((lo[0], lo[1]), (hi[0], hi[1]), (lo[0], hi[1])):
            p = {"uuid": "edge", "trace": [{"lat": float(lat),
                                            "lon": float(lon)}]}
            assert pr.route(p) == jr.route(p) == name
        out = {"uuid": "edge", "trace": [{
            "lat": float(lo[1]), "lon": float(np.nextafter(lo[0], -np.inf))}]}
        with pytest.raises(JBadRequest):
            jr.route(out)
        with pytest.raises(UnroutableTrace):
            pr.route(out)


def test_wsgi_health_report_stats(routers, metros):
    jr, pr, jb, pb = routers
    a = metros[0]
    (js, jh), (ps, ph) = _both(routers, "GET", "/health")
    assert ps == js == 200
    assert set(ph["metros"]) == set(jh["metros"]) == set(pr.apps)
    assert ph["unroutable"] == jh["unroutable"]
    for name, h in ph["metros"].items():
        # the port's app adds "device" to the JAX app's keys
        assert set(h) - {"device"} == set(jh["metros"][name])
        assert h["link"].keys() == jh["metros"][name]["link"].keys()
    (js, jbody), (ps, pbody) = _both(routers, "POST", "/report",
                                     _probe(a, 9))
    assert ps == js == 200 and pbody == jbody and pbody["metro"] == a.name
    (js, jst), (ps, pst) = _both(routers, "GET", "/stats")
    assert ps == js == 200 and set(pst) == set(jst) == set(pr.apps)
    assert pst[a.name]["traces"] == jst[a.name]["traces"]
    assert pb == jb


def test_nested_metros_route_most_specific():
    """Nested boxes route to the smallest, in either tileset order, in
    both packages."""
    big = compile_network(generate_city("tiny", nx=16, ny=16, seed=2),
                          JCompilerParams(reach_radius=400.0))
    big.name = "big"
    small = compile_network(generate_city("tiny", nx=6, ny=6, seed=3),
                            JCompilerParams(reach_radius=400.0))
    small.name = "small"
    payload = synthesize_probe(small, seed=4, num_points=20,
                               gps_sigma=3.0).to_report_json()
    for order in ([big, small], [small, big]):
        jr = jmake_router(order, JConfig(
            matcher=JMatcherParams(candidate_backend="dense")),
            transport=lambda u, b: 200)
        pr = make_router([_port(t) for t in order], Config(),
                         transport=lambda u, b: 200, device="cpu")
        try:
            assert pr.route(payload) == jr.route(payload) == "small"
            assert pr.report_one(payload) == jr.report_one(payload)
        finally:
            jr.close()
            pr.close()


def test_construction_errors(metros):
    a = _port(metros[0])
    with pytest.raises(ValueError, match="at least one"):
        MetroRouter([], device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        MetroRouter([a, a], device="cpu")
    # meshes are ported (they raised naming ROADMAP item 7 before): one
    # for an unknown metro raises, as the JAX router's does
    from reporter_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="unknown metros"):
        MetroRouter([a], meshes={"nope": make_mesh(
            dp=2, devices=["cpu"] * 2)}, device="cpu")


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_server_entry_point_with_several_tiles_starts_the_router(
        metros, tmp_path):
    """python -m reporter_tpu_torch.service.server --tiles a.npz b.npz
    --device cpu: the log names router[a, b], /report answers as an
    in-process port router does, a far trace gets 404 with the known
    metros, /health lists both, and SIGINT drains to exit code 0."""
    paths = [_port(t).save(str(tmp_path / t.name)) for t in metros]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, RTPU_LINK_PROBE="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "reporter_tpu_torch.service.server",
         "--tiles", *paths, "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0"], cwd=str(tmp_path), env=env,
        stderr=subprocess.PIPE, text=True)
    ready, lines = threading.Event(), []

    def read():
        for ln in proc.stderr:
            lines.append(ln)
            if " serving " in ln:
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    ref = make_router([_port(t) for t in metros], Config(), device="cpu")
    try:
        assert ready.wait(WAIT), "".join(lines)
        line = next(ln for ln in lines if " serving " in ln)
        assert f"router[{metros[0].name}, {metros[1].name}]" in line
        port = int(line.split(" on 127.0.0.1:")[1].split(",")[0])
        base = f"http://127.0.0.1:{port}"
        for ts, seed in zip(metros, (31, 32)):
            p = _probe(ts, seed, 50)
            status, body = _post(base + "/report", p)
            assert status == 200 and body == ref.report_one(p)
            assert body["metro"] == ts.name
        status, body = _post(base + "/report", {
            "uuid": "far", "trace": [{"lat": -45.0, "lon": 100.0}]})
        assert status == 404
        assert body["known_metros"] == sorted(t.name for t in metros)
        with urllib.request.urlopen(base + "/health", timeout=WAIT) as r:
            health = json.loads(r.read())
        assert set(health["metros"]) == {t.name for t in metros}
        assert health["unroutable"] == 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(WAIT) == 0
        reader.join(WAIT)
        assert any("draining scheduler" in ln for ln in lines)
    finally:
        ref.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(WAIT)
