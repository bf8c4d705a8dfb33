"""The port's topology plane (reporter_tpu_torch/distributed/ and the
export / merge / delta forms of utils/metrics.py) against the JAX
package's, on the CPU.

Tolerance 0 throughout. The same observation streams, drawn with numpy
from a seed, feed a JAX and a port registry per member: the merged
exports, their Prometheus text and the windowed deltas are equal.
Snapshot files written by either package are read by the other, and
``load_dir`` / ``fleet_exposition`` agree; ``stitch`` of the same dumps
gives equal documents; the report sinks count alike; the supervisors
evaluate the same SLO verdict over one snapshot spool.

Then the port's ``Supervisor`` itself: trivial ``python -c`` members for
the death / restart / event mechanics (tests/test_distributed.py's
cases), and a real topology of two port workers (``--device cpu``) over
a pre-staged durable broker on a tiny tile: worker-0 is SIGKILLed with
lag outstanding, the supervisor detects the death and restarts it from
its checkpoint, the topology drains, the sink's reports cover an
uninterrupted in-process pipeline's, the merged ``/metrics`` equals the
per-leaf sum of the members' snapshots, and ``/metrics``, ``/health``
and ``/slo`` answer over WSGI.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest

from reporter_tpu.distributed import Supervisor as JSupervisor
from reporter_tpu.distributed import aggregate as jaggregate
from reporter_tpu.distributed import stitch as jstitch
from reporter_tpu.utils import metrics as jmetrics
from reporter_tpu.utils import tracing as jtracing
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import (CompilerParams, Config, ServiceConfig,
                                       StreamingConfig)
from reporter_tpu_torch.distributed import (MemberSpec, Supervisor,
                                            aggregate, stitch,
                                            worker_member)
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.streaming import DurableIngestQueue, StreamPipeline
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.utils import metrics, tracing

WALL = 1_700_000_000.5      # pinned wall clock: uptime gauges alike


@pytest.fixture
def wall(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)


# ---------------------------------------------------------------------------
# export / merge / delta


_SERIES = ["match_seconds", "report_build_seconds",
           'quality_batches{metro="sf"}', 'quality_batches{metro="oak"}']
_COUNTERS = ["probes", 'fleet_hits{metro="sf"}', 'fleet_hits{metro="oak"}',
             "http_requests", "http_errors"]


def _ops(seed, k=3, n=400):
    """One seeded observation stream: (member, op, name, value)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(k))
        op = int(rng.integers(3))
        if op == 0:   # values over the whole bucket grid, +Inf included
            out.append((m, "observe", _SERIES[rng.integers(len(_SERIES))],
                        float(10.0 ** rng.uniform(-4, 2))))
        elif op == 1:
            out.append((m, "count", _COUNTERS[rng.integers(len(_COUNTERS))],
                        float(rng.integers(1, 5))))
        else:
            out.append((m, "gauge", "stream_lag", float(rng.integers(100))))
    return out


def _registries(mod, ops, k=3):
    regs = [mod.MetricsRegistry() for _ in range(k)]
    for m, op, name, v in ops:
        getattr(regs[m], op)(name, v)
    return regs


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_merge_exports_equal(seed, wall):
    ops = _ops(seed)
    jregs, pregs = _registries(jmetrics, ops), _registries(metrics, ops)
    assert [r.export() for r in pregs] == [r.export() for r in jregs]
    jm = jmetrics.merge_exports({f"w{i}": r.export()
                                 for i, r in enumerate(jregs)})
    pm = metrics.merge_exports({f"w{i}": r.export()
                                for i, r in enumerate(pregs)})
    assert pm.export() == jm.export()
    assert pm.render_prometheus() == jm.render_prometheus()
    assert pm.snapshot() == jm.snapshot()
    # version-skewed exports are skipped alike
    skew = dict(pregs[0].export(), schema=metrics.EXPORT_SCHEMA + 1)
    assert metrics.merge_exports({"a": skew}).export() == \
        jmetrics.merge_exports({"a": skew}).export()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_delta_exports_and_since_equal(seed):
    ops = _ops(seed, k=1, n=600)
    pairs = []   # (t, JAX export, port export) after each 60 ops
    jr, pr = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    for i, (_, op, name, v) in enumerate(ops):
        getattr(jr, op)(name, v)
        getattr(pr, op)(name, v)
        if i % 60 == 59:
            pairs.append((float(i // 60), jr.export(), pr.export()))
    for (_, jo, po), (_, jn, pn) in zip(pairs, pairs[1:]):
        assert metrics.delta_exports(pn, po) == \
            jmetrics.delta_exports(jn, jo)
    # a counter reset (restarted member) clamps at 0 alike
    assert metrics.delta_exports(pairs[0][2], pairs[-1][2]) == \
        jmetrics.delta_exports(pairs[0][1], pairs[-1][1])
    jring, pring = jmetrics.SnapshotRing(cap=6), metrics.SnapshotRing(cap=6)
    for t, je, pe in pairs:
        jring.push(t, je)
        pring.push(t, pe)
        for win in (0.0, 1.0, 2.5, 100.0):
            for now in (None, t + 0.5):
                assert pring.delta_since(win, now) == \
                    jring.delta_since(win, now)
    assert len(pring) == len(jring) == 6
    assert metrics.delta_since([], 5.0) == jmetrics.delta_since([], 5.0)


def test_with_labels_equal():
    for key, extra in [('x{metro="sf"}', {"worker": "w0"}),
                       ('x{metro="sf"}', {"metro": "oak"}),
                       ("plain", {"worker": "w1", "a": "b"}),
                       ('y{b="1",a="2"}', {"c": "q\"uote"})]:
        assert metrics.with_labels(key, **extra) == \
            jmetrics.with_labels(key, **extra)


def test_observe_into_merged_registry_extends_buckets():
    a = metrics.MetricsRegistry()
    a.observe("match_seconds", 0.002)
    merged = metrics.merge_exports({"w0": a.export()})
    before = list(merged._hist["match_seconds"])
    merged.observe("match_seconds", 0.002)
    assert sum(merged._hist["match_seconds"]) == sum(before) + 1


# ---------------------------------------------------------------------------
# the snapshot spool, both ways


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_read_across_packages(tmp_path, wall, writer):
    ops = _ops(5)
    wmod, wagg = ((jmetrics, jaggregate) if writer == "jax"
                  else (metrics, aggregate))
    for i, reg in enumerate(_registries(wmod, ops)):
        wagg.write_snapshot(wagg.snapshot_path(str(tmp_path), f"w{i}"),
                            reg, f"w{i}", seq=i + 1, stats={"lag": i})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    (tmp_path / "garbage.json").write_text("{torn")
    (tmp_path / "foreign.json").write_text('{"other": 1}')
    jsnaps = jaggregate.load_dir(str(tmp_path))
    psnaps = aggregate.load_dir(str(tmp_path))
    assert psnaps == jsnaps and set(psnaps) == {"w0", "w1", "w2"}
    for m in psnaps:
        path = aggregate.snapshot_path(str(tmp_path), m)
        assert aggregate.read_snapshot(path) == jaggregate.read_snapshot(path)
    assert aggregate.fleet_exposition(psnaps) == \
        jaggregate.fleet_exposition(jsnaps)
    assert aggregate.member_health(psnaps, now=WALL + 3) == \
        jaggregate.member_health(jsnaps, now=WALL + 3)
    assert aggregate.merge_registry(psnaps).export() == \
        jaggregate.merge_registry(jsnaps).export()
    # a version-skewed snapshot is skipped by both
    doc = json.loads((tmp_path / "w0.json").read_text())
    doc["schema"] = aggregate.SNAPSHOT_SCHEMA + 1
    (tmp_path / "skewed.json").write_text(json.dumps(doc))
    assert set(aggregate.load_dir(str(tmp_path))) == \
        set(jaggregate.load_dir(str(tmp_path))) == {"w0", "w1", "w2"}


# ---------------------------------------------------------------------------
# trace stitching


def _doc(pid, mono_at_dump, wall_at_dump, events):
    return {"traceEvents": [dict(e, pid=pid) for e in events],
            "clock_sync": {"monotonic_us": mono_at_dump * 1e6,
                           "unix_us": wall_at_dump * 1e6, "pid": pid}}


def _dumps(tmp_path):
    wall = 1_700_000_000.0
    prod = _doc(10, 200.0, wall, [
        {"name": "produce", "ph": "X", "tid": 1, "ts": 101.0 * 1e6,
         "dur": 1000.0, "args": {"trace_id": "t1"}},
        {"name": "produce", "ph": "X", "tid": 1, "ts": 101.5 * 1e6,
         "dur": 800.0, "args": {"trace_id": "t2"}}])
    work = _doc(20, 5000.0, wall, [
        {"name": "consume", "ph": "X", "tid": 2, "ts": 4902.0 * 1e6,
         "dur": 300.0, "args": {"trace_ids": ["t1", "t2"], "traced": 2}},
        {"name": "worker_match", "ph": "X", "tid": 1,
         "ts": (5000.0 - 97.0) * 1e6, "dur": 2000.0,
         "args": {"trace_ids": ["t1"], "traced": 4}}])
    solo = _doc(30, 7.0, wall, [
        {"name": "a", "ph": "X", "tid": 1, "ts": 0.0, "dur": 1.0,
         "args": {"trace_id": "x"}}])
    legacy = {"traceEvents": [{"name": "old", "ph": "X", "pid": 3,
                               "tid": 1, "ts": 1.0, "dur": 1.0,
                               "args": {"trace_id": "t2"}}]}
    path = tmp_path / "legacy.json"
    path.write_text(json.dumps(legacy))
    # a real dump of the port's recorder beside the synthetic ones
    rec = tracing.FlightRecorder(capacity=64).configure(enabled=True)
    with rec.span("produce", trace_id="t1"):
        pass
    real = str(tmp_path / "ring_real.json")
    rec.dump(path=real, reason="test")
    return {"producer": prod, "worker-0": work, "solo": solo,
            "legacy": str(path), "missing": str(tmp_path / "none.json"),
            "real": real}


def test_stitch_equal(tmp_path):
    dumps = _dumps(tmp_path)
    pout = stitch.stitch(dumps, out_path=str(tmp_path / "p.json"))
    jout = jstitch.stitch(dumps, out_path=str(tmp_path / "j.json"))
    assert pout == jout
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    st = pout["stitched"]
    assert st["processes"] == 5 and st["unsynced_processes"] == 1
    assert st["cross_pid_tracks"] >= 2
    assert any(e["name"] == "broker_dwell" for e in pout["traceEvents"])
    for path in (dumps["legacy"], dumps["missing"], dumps["real"]):
        assert stitch.load_dump(path) == jstitch.load_dump(path)


def test_stitch_reads_the_other_package_dumps(tmp_path):
    """A JAX recorder's dump and a port recorder's dump stitch into one
    trace with a flow between them, whichever package stitches."""
    jrec = jtracing.FlightRecorder(capacity=64).configure(enabled=True)
    prec = tracing.FlightRecorder(capacity=64).configure(enabled=True)
    with jrec.span("produce", trace_id="k1"):
        time.sleep(0.001)
    with prec.span("worker_match", trace_ids=["k1"], traced=1):
        pass
    jdoc = jrec.to_chrome(reason="t")
    pdoc = prec.to_chrome(reason="t")
    jdoc = json.loads(json.dumps(jdoc))
    for e in jdoc["traceEvents"]:        # two processes, as in a topology
        e["pid"] = e.get("pid", 0) + 1_000_000
    dumps = {"producer": jdoc, "worker-0": pdoc}
    out = stitch.stitch(dumps)
    assert out == jstitch.stitch(dumps)
    assert out["stitched"]["cross_pid_tracks"] == 1


# ---------------------------------------------------------------------------
# supervisor mechanics on trivial members


def _specs():
    ok = MemberSpec("ok", [sys.executable, "-c",
                           "import json; print(json.dumps("
                           "{'steps': 1, 'link': {}, 'quality': {}}))"])
    bad = MemberSpec("bad", [sys.executable, "-c", "import sys; sys.exit(3)"])
    return [ok, bad]


def _wait(pred, timeout=30.0):
    """Poll ``pred`` until it holds or ``timeout`` seconds pass."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.headers.get("Content-Type"), resp.read()


def test_supervisor_death_restart_and_clean_exit(tmp_path):
    sup = Supervisor(_specs(), str(tmp_path), restart=True, max_restarts=1,
                     poll_s=0.02)
    sup.start()
    try:
        assert _wait(sup.drained)
        assert _wait(lambda: (sup.poll_once() or True)
                     and sup.health()["members"]["bad"]["deaths"] >= 2)
        h = sup.health()
        assert h["members"]["bad"]["restarts"] == 1
        assert h["members"]["ok"]["clean_exits"] == 1
        assert h["members"]["ok"]["deaths"] == 0      # not a death
        assert h["deaths_total"] >= 2 and h["restarts_total"] == 1
        kinds = [e["event"] for e in sup.events()]
        assert kinds[0] == "topology_start"
        assert "member_death" in kinds and "member_exit" in kinds
        assert "restart_budget_exhausted" in kinds
        assert not any(e["event"] == "member_death" and e["member"] == "ok"
                       for e in sup.events())
        assert sup.exit_reports()["ok"] == {"steps": 1, "link": {},
                                            "quality": {}}
        assert "rtpu_topo_deaths" in sup.metrics_text()
    finally:
        sup.stop()


def test_supervisor_stop_idempotent_and_noops(tmp_path):
    sup = Supervisor(_specs()[:1], str(tmp_path), poll_s=0.02)
    sup.start()
    assert sup.kill_member("ghost") is None
    assert _wait(sup.drained)
    sup.poll_once()
    assert sup.kill_member("ok") is None
    assert sup.remove_member("ghost") is None
    sup.stop()
    sup.stop()
    kinds = [e["event"] for e in sup.events()]
    assert kinds.count("stop_noop") == 1 and kinds.count("kill_noop") == 2
    assert "member_remove_noop" in kinds
    with pytest.raises(RuntimeError):
        sup.add_member(MemberSpec("late", ["true"]))


def test_member_env_and_worker_member(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASTORE_URL", "http://real-datastore.invalid/")
    sup = Supervisor([], str(tmp_path), poll_s=0.02)
    try:
        env = sup._member_env(MemberSpec("w", ["true"]))
        assert env["DATASTORE_URL"] == sup.sink.url
        assert env["RTPU_TOPO_MEMBER"] == "w"
        assert env["RTPU_TOPO_SNAPSHOT_DIR"] == sup.snapshot_dir
        import reporter_tpu_torch
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(reporter_tpu_torch.__file__)))
        assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    finally:
        sup.stop()
    spec = worker_member("w0", "t.npz", "b", str(tmp_path), partitions=[0],
                         extra_args=["--device", "cpu"])
    assert spec.cmd[1:3] == ["-m", "reporter_tpu_torch.streaming"]
    assert spec.cmd[-2:] == ["--device", "cpu"]
    with pytest.raises(ValueError):
        worker_member("w0", "t.npz", "b", str(tmp_path), partitions=[0],
                      lease_dir="l")


def test_report_sink_counts_rows_like_jax(tmp_path):
    body = json.dumps({"reports": [
        {"id": 1, "next_id": 2, "t0": 0.004, "t1": 1.0},
        {"id": 1, "next_id": 2, "t0": 0.0, "t1": 1.001},
        {"id": 3, "next_id": None, "t0": 5.0, "t1": 9.0}],
        "histograms": {}}).encode()
    got = []
    for cls in (JSupervisor, Supervisor):
        sup = cls([], str(tmp_path / cls.__module__), poll_s=0.02)
        try:
            for payload in (body, b"{not json"):
                req = urllib.request.Request(sup.sink.url, data=payload)
                assert urllib.request.urlopen(req, timeout=10).status == 200
            st = sup.sink.stats()
            got.append((st["rows"], st["posts"], dict(sup.sink.reports)))
        finally:
            sup.stop()
    assert got[0] == got[1] and got[1][0] == 3 and got[1][1] == 2


def test_supervisor_slo_over_one_spool_equals_jax(tmp_path, monkeypatch):
    """Both supervisors over one snapshot spool: the same merged-export
    burn, alert and /slo body (an injected clock each)."""
    monkeypatch.setattr(time, "time", lambda: WALL)
    sups, clock = [], {"now": 0.0}
    for name, cls in (("j", JSupervisor), ("p", Supervisor)):
        sup = cls([], str(tmp_path / name), poll_s=0.02)
        assert sup.slo is not None            # on by default
        sup.snapshot_dir = str(tmp_path / "spool")
        # an injected-clock twin of each package's own evaluator and
        # ledger, over the merged source
        sup.slo = type(sup.slo)(
            sup.metrics, source=lambda s=sup: s.merged_registry().export(),
            ledger=type(sup.slo.ledger)(sup.alerts_path),
            clock=lambda: clock["now"], scale=0.1, min_tick_s=0.0,
            sample_gauges=False, enabled_override=True)
        sups.append(sup)
    w1, w2 = metrics.MetricsRegistry(), metrics.MetricsRegistry()
    try:
        for t in range(40):
            clock["now"] += 1.0
            for w in (w1, w2):
                w.count("http_requests", 5)
                if t >= 10:
                    w.count("http_errors", 5)
            for name, w in (("w1", w1), ("w2", w2)):
                aggregate.write_snapshot(aggregate.snapshot_path(
                    str(tmp_path / "spool"), name), w, name, seq=t)
            for sup in sups:
                sup.slo.tick()
        jsup, psup = sups
        assert psup.slo.status() == jsup.slo.status()
        assert "availability" in psup.slo.status()["active"]
        assert psup.health()["slo"] == jsup.health()["slo"]
        with open(jsup.alerts_path, "rb") as a, \
                open(psup.alerts_path, "rb") as b:
            assert a.read() == b.read()
        bodies = []
        for sup in sups:
            got = {}
            body = b"".join(sup.wsgi({"REQUEST_METHOD": "GET",
                                      "PATH_INFO": "/slo"},
                                     lambda s, h: got.update(s=s)))
            bodies.append((got["s"], json.loads(body)))
        assert bodies[0] == bodies[1] and bodies[1][0].startswith("200")
    finally:
        for sup in sups:
            sup.stop()


# ---------------------------------------------------------------------------
# a real topology: two port workers on the CPU


N_VEH, N_PTS = 32, 60
TOPO_LIMIT_S = 55.0     # the topology test's bound, spawns to drain
# small polls, so the kill lands with lag outstanding; each poll brings
# every vehicle flush_min_points points, so each step flushes and moves
# the commit floor (a worker under --exit-on-drain whose floor stands
# still for three steps takes itself for drained)
TOPO_CFG = {"streaming": {"poll_max_records": 16, "flush_min_points": 2,
                          "hist_flush_interval": 0.0,
                          "flush_max_age": 1e6}}


@pytest.fixture(scope="module")
def topo_env(tmp_path_factory):
    d = tmp_path_factory.mktemp("topo")
    ts = compile_network(generate_city("tiny"),
                         CompilerParams(osmlr_max_length=250.0))
    tiles = ts.save(str(d / "tiles.npz"))
    fleet = synthesize_fleet(ts, N_VEH, num_points=N_PTS, seed=9)
    broker = str(d / "broker")
    q = DurableIngestQueue(broker, 4)
    for t in range(N_PTS):           # round-robin, time-major
        for p in fleet:
            q.append({"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
                      "lon": float(p.lonlat[t, 0]),
                      "time": float(p.times[t])})
    ends = [q.end_offset(p) for p in range(4)]
    q.close()
    cfg = str(d / "worker.json")
    with open(cfg, "w") as f:
        json.dump(TOPO_CFG, f)
    # the uninterrupted run: one in-process pipeline over a copy
    shutil.copytree(broker, broker + "_copy")
    cap = []
    qc = DurableIngestQueue(broker + "_copy")
    pipe = StreamPipeline(ts, Config(
        service=ServiceConfig(datastore_url="http://x/"),
        streaming=StreamingConfig(**TOPO_CFG["streaming"])), queue=qc,
        transport=lambda u, b: cap.append(json.loads(b)) or 200,
        device="cpu")
    while True:
        n = pipe.step()
        if pipe._consumed == ends and n == 0:
            break
    pipe.drain()
    qc.close()
    want = Counter((r.get("id"), r.get("next_id"),
                    round(float(r.get("t0", 0.0)), 2),
                    round(float(r.get("t1", 0.0)), 2))
                   for b in cap for r in b.get("reports", ()))
    return {"dir": d, "tiles": tiles, "broker": broker, "ends": ends,
            "cfg": cfg, "want": want}


@pytest.mark.usefixtures("few_torch_threads")
def test_supervised_workers_survive_a_kill(topo_env, tmp_path):
    e = topo_env
    assert sum(e["want"].values()) > 0
    members = [worker_member(f"worker-{i}", e["tiles"], e["broker"],
                             str(tmp_path), partitions=parts,
                             config=e["cfg"],
                             extra_args=["--device", "cpu"])
               for i, parts in enumerate(([0, 1], [2, 3]))]
    sup = Supervisor(members, str(tmp_path), restart=True, max_restarts=2,
                     poll_s=0.05,
                     base_env={"RTPU_TOPO_SNAPSHOT_INTERVAL_S": "0.2",
                               "OMP_NUM_THREADS": "2"})
    deadline = time.monotonic() + TOPO_LIMIT_S

    def left():
        return max(0.0, deadline - time.monotonic())

    sup.start()
    http = sup.serve_http()
    try:
        assert _wait(lambda: sup.sink.stats()["rows"] > 0, left())
        killed = sup.kill_member("worker-0")
        assert killed is not None, "worker-0 drained before the kill"
        assert _wait(lambda: any(
            ev["event"] == "member_death" and ev["member"] == "worker-0"
            for ev in sup.events()), left())
        assert _wait(sup.drained, left())
        time.sleep(0.1)
        sup.poll_once()
        reports = sup.exit_reports()
        assert reports["worker-0"]["committed"][:2] == e["ends"][:2]
        assert reports["worker-1"]["committed"][2:] == e["ends"][2:]
        assert all(r["lag"] == 0 and set(r["slo"]) == {
            "active", "alerts_total", "ticks", "budget_remaining"}
            for r in reports.values())
        h = sup.health()
        assert h["members"]["worker-0"]["deaths"] == 1
        assert h["members"]["worker-0"]["restarts"] == 1
        assert h["restarts_total"] == 1
        spawns = [ev for ev in sup.events() if ev["event"] == "member_spawn"
                  and ev["member"] == "worker-0"]
        assert [ev["reason"] for ev in spawns] == ["start", "restart"]
        have = Counter(sup.sink.reports)
        assert not (e["want"] - have), "a report of the uninterrupted run "\
            "is missing"
        # the merged exposition is the per-leaf sum of the snapshots
        snaps = sup.snapshots()
        assert set(snaps) == {"worker-0", "worker-1"}
        merged = aggregate.merge_registry(snaps)
        want_c, want_h = Counter(), {}
        for doc in snaps.values():
            want_c.update(doc["metrics"]["counters"])
            for k, b in doc["metrics"]["hist"].items():
                want_h[k] = [x + y for x, y in
                             zip(want_h.get(k, [0] * len(b)), b)]
        assert merged._counters == dict(want_c)
        assert merged._hist == want_h
        port = http.server_address[1]
        ctype, text = _get(port, "/metrics")
        assert ctype.startswith("text/plain")
        assert b"rtpu_topo_deaths" in text and b"rtpu_probes" in text
        health = json.loads(_get(port, "/health")[1])
        assert health["sink"]["rows"] == sup.sink.stats()["rows"]
        assert set(health["members"]) == {"worker-0", "worker-1"}
        slo_body = json.loads(_get(port, "/slo")[1])
        assert slo_body["enabled"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/nope")
        assert ei.value.code == 404
    finally:
        sup.stop()
