"""The port's columnar streaming worker (reporter_tpu_torch/streaming/
columnar.py, durable_columnar.py) against the JAX package's, on the CPU.

Parity, tolerance 0: the same record stream, built with numpy from a
seed, goes in rounds through the JAX ``ColumnarStreamPipeline`` (dense
candidates) and the port's on ``device="cpu"``, at pipeline depth 0 and
1, each with a fake clock; the published bodies (the report POSTs and
the histogram flushes, each stream in its order), both histograms,
``committed`` and ``malformed`` must be equal. At depth 1 each round
waits for the in-flight wave's match before its step, so both sides
flush every uuid at the same points. A columnar broker directory written
by either package opens in the other.

Then the JAX package's columnar tests (tests/test_streaming_columnar.py,
test_durable_columnar.py) and the contracts of test_pipelined_flush.py on
the port's modules. Those hold a wave "on the card" with an event-gated
stand-in for ``match_many`` and a gated transport; every wait is on an
event or a future with a bounded timeout, and no test sleeps for a fixed
time.
"""

import concurrent.futures
import json
import os
import threading

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.streaming import (
    ColumnarStreamPipeline as JColumnarStreamPipeline)
from reporter_tpu.streaming import (
    DurableColumnarIngestQueue as JDurableColumnarIngestQueue)
from reporter_tpu.streaming import pack_records as jpack_records
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch import faults
from reporter_tpu_torch.config import (Config, ServiceConfig,
                                       StreamingConfig)
from reporter_tpu_torch.matcher.native_walk import (RecordColumns,
                                                    materialize_records,
                                                    record_bounds)
from reporter_tpu_torch.matcher.segments import SegmentRecord
from reporter_tpu_torch.netgen import traces as ptraces
from reporter_tpu_torch.service.datastore import (AsyncDatastorePublisher,
                                                  DatastorePublisher)
from reporter_tpu_torch.service.reports import Report, build_reports
from reporter_tpu_torch.streaming import (ColumnarIngestQueue,
                                          ColumnarStreamPipeline,
                                          DurableColumnarIngestQueue,
                                          DurableIngestQueue, IngestQueue,
                                          StreamPipeline, pack_records)
from reporter_tpu_torch.streaming.columnar import (ProbeColumns,
                                                   _WaveController,
                                                   build_report_columns)
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

URL = "http://ds.test/"
WAIT = 30.0        # the bound of every wait on an event or a future (s)


@pytest.fixture(scope="module")
def jtiles():
    return compile_network(
        generate_city("tiny"),
        JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0))


@pytest.fixture(scope="module")
def tiles(jtiles):
    return TileSet.from_arrays(jtiles.name, jtiles.meta.origin_lonlat,
                               {f: getattr(jtiles, f) for f in _ARRAY_FIELDS})


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _records(probes, accuracy_for=()):
    """Round-robin interleave of the probes' points (firehose shape)."""
    out = []
    T = max(len(p.times) for p in probes)
    for t in range(T):
        for i, p in enumerate(probes):
            if t < len(p.times):
                rec = {"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
                       "lon": float(p.lonlat[t, 0]),
                       "time": float(p.times[t])}
                if i in accuracy_for:
                    rec["accuracy"] = 8.0 + (t % 5)
                out.append(rec)
    return out


def _capture(sink):
    return lambda url, body: sink.append(json.loads(body)) or 200


def _settle(pipe):
    """Wait (bounded) for the in-flight waves' matches: the next step
    harvests them, so a round meets the sequential flush points."""
    futs = [w.future for w in pipe._inflight if w.future is not None]
    if futs:
        concurrent.futures.wait(futs, timeout=WAIT)


def _reports(captured):
    """Every published report row, sorted (exact values)."""
    return sorted(json.dumps(r, sort_keys=True) for p in captured
                  for r in p.get("reports", []))


# ---------------------------------------------------------------------------
# Parity with the JAX package


def _stream(jtiles, seed, n=7, points=40):
    rng = np.random.default_rng(seed)
    probes = [synthesize_probe(jtiles, seed=int(s), num_points=points,
                               gps_sigma=3.0)
              for s in rng.integers(0, 10_000, n)]
    recs = _records(probes)
    acc = rng.uniform(2.0, 30.0, len(recs))
    for i, r in enumerate(recs):
        if r["uuid"] == probes[2].uuid:
            del r["time"]
        elif rng.random() < 0.25:
            r["accuracy"] = float(acc[i])
    for at, bad in zip(sorted(rng.choice(len(recs), 3, replace=False)),
                       ({"uuid": "", "lat": 1.0, "lon": 2.0},
                        {"uuid": "vx", "lat": "bogus", "lon": 2.0},
                        {"uuid": "vy", "lat": 1.0, "lon": 2.0,
                         "time": float("inf")})):
        recs.insert(int(at), bad)
    return recs


@pytest.mark.parametrize("depth", [0, 1])
def test_columnar_parity_with_jax(jtiles, tiles, depth):
    recs = _stream(jtiles, 19)
    kw = dict(flush_min_points=10, flush_max_age=5.0, poll_max_records=48,
              hist_flush_interval=6.0, pipeline_depth=depth)
    jpub, ppub = [], []
    jclock, pclock = FakeClock(), FakeClock()
    jp = JColumnarStreamPipeline(
        jtiles, JConfig(matcher=JMatcherParams(candidate_backend="dense"),
                        service=JServiceConfig(datastore_url=URL),
                        streaming=JStreamingConfig(**kw)),
        transport=_capture(jpub), clock=jclock)
    pp = ColumnarStreamPipeline(
        tiles, Config(service=ServiceConfig(datastore_url=URL),
                      streaming=StreamingConfig(**kw)),
        transport=_capture(ppub), clock=pclock, device="cpu")
    for pipe, clock, pack in ((jp, jclock, jpack_records),
                              (pp, pclock, pack_records)):
        for chunk in np.array_split(np.arange(len(recs)), 6):
            pipe.queue.append_columns(pack([recs[i] for i in chunk]))
            _settle(pipe)
            pipe.step()
            clock.now += 2.0
        pipe.drain()
        pipe.flush_histograms()
        pipe.close()
    # the report POSTs (in wave order, on the publisher's thread at depth
    # 1) and the histogram flushes (on the pipeline's thread) are two
    # streams, each in order; how they interleave is not a contract
    for key in ("reports", "histograms"):
        assert [b for b in ppub if key in b] == [b for b in jpub if key in b]
    assert _reports(ppub) and any("histograms" in b for b in ppub)
    np.testing.assert_array_equal(pp.hist.snapshot(), jp.hist.snapshot())
    np.testing.assert_array_equal(pp.qhist.snapshot(), jp.qhist.snapshot())
    assert pp.committed == jp.committed
    assert pp.malformed == jp.malformed == 3
    assert pp.stats()["lag"] == 0


def test_durable_columnar_broker_between_packages(tmp_path):
    """A columnar broker directory written by either package opens in the
    other: same offsets, same rows (the uuid column as written), and an
    append by the other package lands after them."""
    rng = np.random.default_rng(6)
    recs = [{"uuid": f"v{int(u)}", "lat": float(la), "lon": float(lo),
             "time": float(t)}
            for u, la, lo, t in zip(rng.integers(0, 9, 60),
                                    rng.uniform(37, 38, 60),
                                    rng.uniform(-123, -122, 60),
                                    np.arange(60.0))]
    recs[3]["accuracy"] = 7.5
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jq = JDurableColumnarIngestQueue(a, num_partitions=3)
    pq = DurableColumnarIngestQueue(b, num_partitions=3)
    for lo in range(0, 60, 20):
        jq.append_columns(jpack_records(recs[lo:lo + 20]))
        pq.append_columns(pack_records(recs[lo:lo + 20]))
    jq.truncate([5, 0, 0])
    pq.truncate([5, 0, 0])
    jq.close()
    pq.close()
    with open(os.path.join(a, "meta.json")) as f1, \
            open(os.path.join(b, "meta.json")) as f2:
        assert json.load(f1) == json.load(f2) == {"num_partitions": 3,
                                                  "format": "columnar"}
    pq2 = DurableColumnarIngestQueue(a, num_partitions=3)    # JAX-written
    jq2 = JDurableColumnarIngestQueue(b, num_partitions=3)   # port-written
    for p in range(3):
        assert pq2.end_offset(p) == jq2.end_offset(p)
        lo = pq2.retention_floor(p)
        assert lo == jq2.retention_floor(p)
        assert pq2.poll(p, lo, 1000) == jq2.poll(p, lo, 1000)
        for (ob, cb), (oj, cj) in zip(pq2.poll_batch(p, lo, 1000),
                                      jq2.poll_batch(p, lo, 1000)):
            assert ob == oj
            for x, y in zip(cb, cj):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    pq2.append_columns(pack_records(recs[:1]))
    pq2.close()
    jq3 = JDurableColumnarIngestQueue(a, num_partitions=3)
    assert sum(jq3.end_offset(p) for p in range(3)) == 61
    jq2.close()
    jq3.close()


def test_mesh_raises(tiles):
    """The mesh arm (once refused naming ROADMAP item 7): the matcher
    over the mesh; a mesh beside a device raises."""
    from reporter_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    pipe = ColumnarStreamPipeline(tiles, Config(), mesh=mesh)
    assert pipe.matcher.wire_mesh is mesh
    with pytest.raises(ValueError, match="not both"):
        ColumnarStreamPipeline(tiles, Config(), mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# Columnar vs dict (tests/test_streaming_columnar.py)


def _dual(tiles, **stream_kw):
    """One dict and one columnar pipeline, same config, separate capture
    lists, lock-stepped fake clocks."""
    cfg = Config(service=ServiceConfig(datastore_url=URL),
                 streaming=StreamingConfig(**stream_kw))
    caps = ([], [])
    cd, cc = FakeClock(), FakeClock()
    dpipe = StreamPipeline(tiles, cfg, transport=_capture(caps[0]),
                           clock=cd, device="cpu")
    cpipe = ColumnarStreamPipeline(tiles, cfg, transport=_capture(caps[1]),
                                   clock=cc, device="cpu")
    return dpipe, cpipe, caps, (cd, cc)


def _assert_parity(dpipe, cpipe, caps):
    assert _reports(caps[1]) == _reports(caps[0])
    np.testing.assert_array_equal(cpipe.hist.snapshot(),
                                  dpipe.hist.snapshot())
    np.testing.assert_array_equal(cpipe.qhist.snapshot(),
                                  dpipe.qhist.snapshot())
    assert cpipe.committed == dpipe.committed
    assert cpipe.malformed == dpipe.malformed
    ddump, cdump = dpipe.app.cache.dump(), cpipe.cache.dump()
    assert sorted(ddump) == sorted(cdump)
    for u in ddump:
        assert ddump[u]["points"] == cdump[u]["points"], u


def _step_both(dpipe, cpipe):
    dpipe.step()
    _settle(cpipe)
    cpipe.step()


class TestDictParity:
    def test_firehose_parity(self, tiles):
        probes = [ptraces.synthesize_probe(tiles, seed=s, num_points=40,
                                           gps_sigma=3.0) for s in range(12)]
        recs = _records(probes, accuracy_for={3, 7})
        dpipe, cpipe, caps, clocks = _dual(
            tiles, flush_min_points=16, flush_max_age=5.0,
            poll_max_records=200, hist_flush_interval=0.0)
        dpipe.queue.append_many(recs)
        cpipe.queue.append_many(recs)
        for dt in (0.0, 1.0, 6.0, 0.5):
            for c in clocks:
                c.now += dt
            _step_both(dpipe, cpipe)
        dpipe.drain()
        cpipe.drain()
        assert dpipe.flush_histograms() == cpipe.flush_histograms()
        _assert_parity(dpipe, cpipe, caps)
        dh = [p for p in caps[0] if "histograms" in p]
        assert dh == [p for p in caps[1] if "histograms" in p]
        assert len(dh) == 1
        assert cpipe.stats()["reports"] == dpipe.stats()["reports"] > 0
        cpipe.close()

    def test_malformed_timeless_and_nonfinite_parity(self, tiles):
        probes = [ptraces.synthesize_probe(tiles, seed=90 + s, num_points=24,
                                           gps_sigma=3.0) for s in range(4)]
        recs = _records(probes)
        for i, r in enumerate(recs):
            if r["uuid"] == probes[0].uuid:
                del r["time"]
            if i % 17 == 0:
                r["accuracy"] = -3.0
        recs.insert(5, {"uuid": "", "lat": 1.0, "lon": 2.0})
        recs.insert(9, {"uuid": "vx", "lat": "bogus", "lon": 2.0})
        recs.insert(13, {"uuid": "vy", "lat": 1.0, "lon": 2.0,
                         "time": "not-a-time"})
        recs.insert(17, {"uuid": "vz", "lat": 37.75, "lon": -122.41,
                         "time": float("inf")})
        recs.insert(21, {"uuid": "vw", "lat": 37.75, "lon": -122.41,
                         "time": float("nan")})
        dpipe, cpipe, caps, _ = _dual(
            tiles, flush_min_points=8, flush_max_age=1e9,
            poll_max_records=1000, hist_flush_interval=0.0)
        dpipe.queue.append_many(recs)
        cpipe.queue.append_many(recs)
        _step_both(dpipe, cpipe)
        dpipe.drain()
        cpipe.drain()
        assert cpipe.malformed == dpipe.malformed == 5
        _assert_parity(dpipe, cpipe, caps)
        cpipe.close()

    def test_multi_flush_tail_retention_parity(self, tiles):
        probes = [ptraces.synthesize_probe(tiles, seed=40 + s, num_points=60,
                                           gps_sigma=3.0) for s in range(6)]
        recs = _records(probes)
        half = len(recs) // 2
        dpipe, cpipe, caps, _ = _dual(
            tiles, flush_min_points=10, flush_max_age=1e9,
            poll_max_records=10_000, hist_flush_interval=0.0)
        for chunk in (recs[:half], recs[half:]):
            dpipe.queue.append_many(chunk)
            cpipe.queue.append_many(chunk)
            _step_both(dpipe, cpipe)
        dpipe.drain()
        cpipe.drain()
        _assert_parity(dpipe, cpipe, caps)
        assert _reports(caps[0])
        cpipe.close()

    def test_checkpoint_cross_restore(self, tiles, tmp_path):
        probes = [ptraces.synthesize_probe(tiles, seed=70 + s, num_points=50,
                                           gps_sigma=3.0) for s in range(5)]
        recs = _records(probes)
        half = len(recs) // 2
        kw = dict(flush_min_points=12, flush_max_age=1e9,
                  poll_max_records=10_000, hist_flush_interval=0.0)
        dpipe, cpipe, _, _ = _dual(tiles, **kw)
        for pipe in (dpipe, cpipe):
            pipe.queue.append_many(recs[:half])
            pipe.step()
        cpipe.checkpoint(str(tmp_path / "col.npz"))
        dpipe.checkpoint(str(tmp_path / "dict.npz"))
        cfg = Config(service=ServiceConfig(datastore_url=URL),
                     streaming=StreamingConfig(**kw))
        cap_d2, cap_c2 = [], []
        d2 = StreamPipeline(tiles, cfg, queue=dpipe.queue,
                            transport=_capture(cap_d2), device="cpu")
        d2.restore(str(tmp_path / "col.npz"))
        c2 = ColumnarStreamPipeline(tiles, cfg, queue=cpipe.queue,
                                    transport=_capture(cap_c2),
                                    device="cpu")
        c2.restore(str(tmp_path / "dict.npz"))
        np.testing.assert_array_equal(d2.hist.snapshot(), c2.hist.snapshot())
        for pipe in (d2, c2):
            pipe.queue.append_many(recs[half:])
            pipe.step()
            pipe.drain()
        assert _reports(cap_d2) == _reports(cap_c2)
        np.testing.assert_array_equal(d2.hist.snapshot(), c2.hist.snapshot())
        cpipe.close()
        c2.close()

    def test_flush_latency_sample(self, tiles):
        probes = [ptraces.synthesize_probe(tiles, seed=7, num_points=30,
                                           gps_sigma=3.0)]
        _, cpipe, _, (_, cc) = _dual(
            tiles, flush_min_points=1000, flush_max_age=1e9,
            poll_max_records=1000, hist_flush_interval=0.0)
        cpipe.queue.append_many(_records(probes))
        cpipe.step()
        assert cpipe.last_flush_latency is None
        cc.now += 2.5
        cpipe.drain()
        lat = cpipe.last_flush_latency
        assert lat is not None and len(lat) == 30 and np.allclose(lat, 2.5)
        cpipe.close()

    def test_dict_pipeline_over_columnar_queue_drops_poison(self, tiles):
        probes = [ptraces.synthesize_probe(tiles, seed=3, num_points=70,
                                           gps_sigma=3.0)]
        recs = _records(probes)
        recs.insert(4, {"uuid": "poison", "lat": "garbage", "lon": 1.0})
        recs.insert(9, {"uuid": probes[0].uuid, "lat": 37.75,
                        "lon": -122.41, "time": "not-a-time"})
        cfg = Config(service=ServiceConfig(datastore_url=URL),
                     streaming=StreamingConfig(flush_min_points=8,
                                               flush_max_age=1e9,
                                               poll_max_records=1000,
                                               hist_flush_interval=0.0))
        q = ColumnarIngestQueue(cfg.streaming.num_partitions)
        q.append_many(recs)
        pipe = StreamPipeline(tiles, cfg, queue=q,
                              transport=lambda u, b: 200, device="cpu")
        n = pipe.step() + pipe.drain()
        assert pipe.malformed == 2 and n > 0 and pipe.stats()["lag"] == 0


# ---------------------------------------------------------------------------
# The columnar broker


class TestColumnarQueue:
    def test_poll_matches_ingest_queue(self):
        recs = [{"uuid": f"v{i % 7}", "lat": float(i), "lon": -float(i),
                 "time": float(i)} for i in range(40)]
        recs[11]["accuracy"] = 4.5
        q0, q1 = IngestQueue(num_partitions=3), ColumnarIngestQueue(3)
        q0.append_many(recs)
        q1.append_many(recs)
        for p in range(3):
            assert q0.end_offset(p) == q1.end_offset(p)
            assert q0.poll(p, 0, 1000) == q1.poll(p, 0, 1000)

    def test_poll_batch_slicing(self):
        q = ColumnarIngestQueue(num_partitions=1)
        for k in range(4):
            q.append_columns(pack_records(
                [{"uuid": "v", "lat": float(k * 10 + i), "lon": 0.0,
                  "time": float(k * 10 + i)} for i in range(5)]))
        got = q.poll_batch(0, 3, 9)
        offs = np.concatenate([base + np.arange(c.n) for base, c in got])
        np.testing.assert_array_equal(offs, np.arange(3, 12))
        np.testing.assert_array_equal(np.concatenate([c.lat for _, c in got]),
                                      [3, 4, 10, 11, 12, 13, 14, 20, 21])

    def test_truncate_floor(self):
        q = ColumnarIngestQueue(num_partitions=1)
        q.append_columns(pack_records(
            [{"uuid": "v", "lat": float(i), "lon": 0.0} for i in range(6)]))
        q.append_columns(pack_records(
            [{"uuid": "v", "lat": float(i), "lon": 0.0} for i in range(4)]))
        q.truncate([7])
        assert q.poll_batch(0, 6, 10)[0][0] == 6
        with pytest.raises(LookupError):
            q.poll_batch(0, 5, 10)
        assert q.end_offset(0) == 10

    def test_reject_policy_counts_and_caps(self):
        q = ColumnarIngestQueue(1, max_records_per_partition=10,
                                overload_policy="reject")
        mk = lambda lo, n: pack_records([   # noqa: E731
            {"uuid": "v", "lat": 1.0, "lon": 2.0, "time": float(lo + i)}
            for i in range(n)])
        assert q.append_columns(mk(0, 8)) == 8
        assert q.append_columns(mk(8, 5)) == 2
        assert q.overload_stats()["broker_rejected"] == 3
        q.truncate([10])
        assert q.append_columns(mk(8, 5)) == 5
        assert q.end_offset(0) == 15

    def test_drop_oldest_policy_advances_floor_and_counts(self):
        q = ColumnarIngestQueue(1, max_records_per_partition=10,
                                overload_policy="drop_oldest")
        for k in range(4):
            q.append_columns(pack_records(
                [{"uuid": "v", "lat": 1.0, "lon": 2.0,
                  "time": float(4 * k + i)} for i in range(4)]))
        assert q.overload_stats()["broker_dropped_oldest"] == 8
        assert q.retention_floor(0) == 8 and q.end_offset(0) == 16
        with pytest.raises(LookupError):
            q.poll_batch(0, 0, 100)
        assert sum(c.n for _, c in q.poll_batch(0, 8, 100)) == 8

    def test_dict_poll_shim_materializes_inf_not_absent(self):
        q = ColumnarIngestQueue(1)
        q.append_columns(ProbeColumns(
            np.array(["a", "a"]), np.array([37.0, 37.0]),
            np.array([-122.0, -122.0]), np.array([np.inf, np.nan]),
            np.full(2, np.nan, np.float32)))
        recs = [r for _, r in q.poll(0, 0, 10)]
        assert recs[0]["time"] == float("inf") and "time" not in recs[1]

    def test_pack_records_poisons_explicit_nonfinite_time(self):
        cols = pack_records([
            {"uuid": "a", "lat": 1.0, "lon": 2.0, "time": 3.0},
            {"uuid": "a", "lat": 1.0, "lon": 2.0, "time": float("nan")},
            {"uuid": "a", "lat": 1.0, "lon": 2.0, "time": float("inf")},
            {"uuid": "a", "lat": 1.0, "lon": 2.0},
            {"uuid": "a", "lat": 1.0, "lon": 2.0, "time": 0.0,
             "accuracy": float("inf")}])
        assert np.isfinite(cols.lat[0]) and cols.time[0] == 3.0
        assert np.isnan(cols.lat[1]) and np.isnan(cols.lat[2])
        assert np.isfinite(cols.lat[3]) and np.isnan(cols.time[3])
        assert np.isfinite(cols.lat[4]) and np.isnan(cols.accuracy[4])

    def test_pack_records_equals_jax(self):
        recs = [{"uuid": "a", "lat": 1.0, "lon": 2.0, "time": 3.0},
                {"uuid": "bb", "lat": "x", "lon": 2.0},
                {"uuid": "a", "lat": 1.5, "lon": 2.5, "accuracy": 4.0}]
        for x, y in zip(pack_records(recs), jpack_records(recs)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


class TestDurableColumnar:
    def _recs(self, n, base=0):
        return [{"uuid": f"v{(base + i) % 5}", "lat": float(base + i),
                 "lon": -float(base + i), "time": float(base + i)}
                for i in range(n)]

    def test_log_survives_process(self, tmp_path):
        d = str(tmp_path / "broker")
        q = DurableColumnarIngestQueue(d, num_partitions=3)
        q.append_columns(pack_records(self._recs(40)))
        q.append_columns(pack_records(self._recs(25, base=40)))
        before = {p: q.poll(p, 0, 10_000) for p in range(3)}
        ends = [q.end_offset(p) for p in range(3)]
        q.close()
        q2 = DurableColumnarIngestQueue(d, num_partitions=3)
        assert [q2.end_offset(p) for p in range(3)] == ends
        assert {p: q2.poll(p, 0, 10_000) for p in range(3)} == before
        q2.append_columns(pack_records(self._recs(10, base=65)))
        assert sum(q2.end_offset(p) for p in range(3)) == 75
        q2.close()

    def test_torn_tail_dropped_and_truncated(self, tmp_path):
        d = str(tmp_path / "broker")
        q = DurableColumnarIngestQueue(d, num_partitions=1)
        q.append_columns(pack_records(self._recs(12)))
        q.append_columns(pack_records(self._recs(8, base=12)))
        q.close()
        path = os.path.join(d, "p0.colog")
        with open(path, "rb+") as f:
            f.truncate(os.path.getsize(path) - 7)
        q2 = DurableColumnarIngestQueue(d, num_partitions=1)
        assert q2.end_offset(0) == 12
        assert [o for o, _ in q2.poll(0, 0, 100)] == list(range(12))
        q2.append_columns(pack_records([{"uuid": "v0", "lat": 1.0,
                                         "lon": 2.0, "time": 99.0}]))
        q2.close()
        q3 = DurableColumnarIngestQueue(d, num_partitions=1)
        assert q3.end_offset(0) == 13
        assert q3.poll(0, 12, 10)[0][1]["time"] == 99.0
        q3.close()

    def test_broker_fault_site_tears_a_frame(self, tmp_path):
        """``broker:torn@1``: the second append writes half its frame and
        dies; the reload keeps the first batch and drops the torn one."""
        d = str(tmp_path / "broker")
        q = DurableColumnarIngestQueue(d, num_partitions=1)
        with faults.use(faults.FaultPlan.parse("broker:torn@1")):
            q.append_columns(pack_records(self._recs(6)))
            with pytest.raises(faults.InjectedCrash):
                q.append_columns(pack_records(self._recs(4, base=6)))
        q.close()
        q2 = DurableColumnarIngestQueue(d, num_partitions=1)
        assert q2.end_offset(0) == 6
        with faults.use(faults.FaultPlan.parse("broker:crash@0")):
            with pytest.raises(faults.InjectedCrash):
                q2.append_columns(pack_records(self._recs(2)))
        q2.close()

    def test_retention_rewrite_survives_reload(self, tmp_path):
        d = str(tmp_path / "broker")
        q = DurableColumnarIngestQueue(d, num_partitions=1)
        for k in range(4):
            q.append_columns(pack_records(self._recs(5, base=5 * k)))
        q.truncate([11])
        q.close()
        q2 = DurableColumnarIngestQueue(d, num_partitions=1)
        assert q2.end_offset(0) == 20
        assert [o for o, _ in q2.poll(0, 10, 100)] == list(range(10, 20))
        with pytest.raises(LookupError):
            q2.poll(0, 5, 10)
        q2.close()

    def test_format_and_partition_count_pinned(self, tmp_path):
        d_col, d_rec = str(tmp_path / "col"), str(tmp_path / "rec")
        DurableColumnarIngestQueue(d_col, num_partitions=2).close()
        with pytest.raises(ValueError, match="format"):
            DurableIngestQueue(d_col, num_partitions=2)
        with pytest.raises(ValueError, match="num_partitions"):
            DurableColumnarIngestQueue(d_col, num_partitions=4)
        DurableIngestQueue(d_rec, num_partitions=2).close()
        with pytest.raises(ValueError, match="format"):
            DurableColumnarIngestQueue(d_rec, num_partitions=2)

    def test_object_uuid_column_survives_reload(self, tmp_path):
        d = str(tmp_path / "broker")
        q = DurableColumnarIngestQueue(d, num_partitions=1)
        q.append_columns(ProbeColumns(
            np.array(["a", "bb", "a"], dtype=object),
            np.array([1.0, 2.0, 3.0]), np.array([-1.0, -2.0, -3.0]),
            np.array([0.0, 0.0, 1.0]), np.full(3, np.nan, np.float32)))
        q.close()
        q2 = DurableColumnarIngestQueue(d, num_partitions=1)
        assert [r["uuid"] for _, r in q2.poll(0, 0, 10)] == ["a", "bb", "a"]
        q2.close()


# ---------------------------------------------------------------------------
# The vectorized report build


def _mk_cols(rows):
    a = np.asarray
    tr, seg, t0, t1, ln, qu, it = (list(x) for x in zip(*rows))
    n = len(tr)
    return RecordColumns(
        a(tr, np.int32), a(seg, np.int64), a(t0, np.float64),
        a(t1, np.float64), a(ln, np.float64), a(qu, np.float64),
        a(it, bool), np.arange(n + 1, dtype=np.int64),
        np.zeros(n, np.int64))


_CASES = [
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, 11, 1.0, 2.0, 60.0, 5.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, -1, 1.0, 1.2, 8.0, 0.0, True),
     (0, 11, 1.2, 2.0, 60.0, 0.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, 11, 3.0, 4.0, 60.0, 0.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, 12, -1.0, 2.0, 20.0, 0.0, False),
     (0, 11, 2.0, 3.0, 60.0, 0.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, -1, 1.5, 1.7, 8.0, 0.0, True),
     (0, 11, 1.7, 2.0, 60.0, 0.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (1, 11, 1.0, 2.0, 60.0, 0.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, 13, 1.0, 1.1, 2.0, 0.0, False),
     (0, 11, 1.1, 2.0, 60.0, 0.0, False)],
    [(0, 10, 0.0, 1.0, 50.0, 0.0, False), (0, -1, 1.0, 1.1, 4.0, 0.0, True),
     (0, -1, 1.1, 1.3, 4.0, 0.0, True), (0, 11, 1.3, 2.0, 60.0, 1.0, False)],
]


def _scalar_reports(cols, n_traces, min_len):
    bounds = record_bounds(cols, n_traces)
    out = []
    for b in range(n_traces):
        out.extend(build_reports(materialize_records(
            cols, int(bounds[b]), int(bounds[b + 1])), min_len))
    return out


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_report_columns_match_scalar_builder(case):
    cols = _mk_cols(_CASES[case])
    n_traces = int(cols.trace.max()) + 1
    seg, nxt, t0, t1, _, _, per_trace = build_report_columns(
        cols, n_traces, 10.0)
    want = _scalar_reports(cols, n_traces, 10.0)
    assert [(int(s), int(x), a, b) for s, x, a, b in zip(seg, nxt, t0, t1)] \
        == [(w.segment_id, -1 if w.next_segment_id is None
             else w.next_segment_id, w.start_time, w.end_time) for w in want]
    assert per_trace.sum() == len(want)


def test_report_columns_fuzz_against_scalar():
    rng = np.random.default_rng(7)
    for _ in range(50):
        rows = []
        for tr in range(3):
            t = 0.0
            for _ in range(int(rng.integers(0, 12))):
                internal = bool(rng.random() < 0.25)
                t0 = t + float(rng.choice([0.0, 0.0, 0.0, 2.0]))
                t1 = t0 + float(rng.choice([0.5, 1.0]))
                rows.append((tr, -1 if internal else int(rng.integers(10, 16)),
                             -1.0 if rng.random() < 0.2 else t0, t1,
                             float(rng.choice([5.0, 30.0])), 0.0, internal))
                t = t1
        if not rows:
            continue
        cols = _mk_cols(rows)
        n_traces = int(cols.trace.max()) + 1
        seg, nxt, t0, t1, _, _, _ = build_report_columns(cols, None, 10.0)
        want = _scalar_reports(cols, n_traces, 10.0)
        assert list(zip(seg.tolist(), nxt.tolist(), t0.tolist(),
                        t1.tolist())) == [
            (w.segment_id, -1 if w.next_segment_id is None
             else w.next_segment_id, w.start_time, w.end_time) for w in want]


# ---------------------------------------------------------------------------
# The publishers' columnar and asynchronous faces


def _report_cols():
    seg = np.array([11, 12, 13], np.int64)
    nxt = np.array([12, -1, 7], np.int64)
    t0 = np.array([0.0, 1.5, 3.25])
    t1 = np.array([1.5, 3.25, 9.0])
    ln = np.array([100.0, 80.5, 40.0])
    qu = np.array([0.0, 12.0, 0.0])
    return seg, nxt, t0, t1, ln, qu


def test_publish_columns_equals_publish_and_jax():
    from reporter_tpu.service.datastore import (
        DatastorePublisher as JDatastorePublisher)

    cols = _report_cols()
    reports = [Report(int(s), None if x < 0 else int(x), a, b, ln, q)
               for s, x, a, b, ln, q in zip(*cols)]
    bodies = {k: [] for k in ("rows", "cols", "jax")}
    DatastorePublisher(URL, transport=_capture(bodies["rows"])).publish(
        reports)
    done = []
    DatastorePublisher(URL, transport=_capture(bodies["cols"])) \
        .publish_columns(*cols, on_done=done.append)
    JDatastorePublisher(URL, transport=_capture(bodies["jax"])) \
        .publish_columns(*cols)
    assert bodies["rows"] == bodies["cols"] == bodies["jax"]
    assert done == [True]


def test_async_publisher_posts_in_order_and_drains():
    gate = threading.Event()
    bodies = []

    def transport(url, body):
        assert gate.wait(WAIT)
        bodies.append(json.loads(body))
        return 200

    pub = AsyncDatastorePublisher(URL, transport=transport)
    done = []
    for k in range(3):
        seg, *rest = _report_cols()
        assert pub.publish_columns(seg + k, *rest,
                                   on_done=lambda ok, k=k: done.append(k))
    assert pub.drain(timeout=0.0) is False     # the gate holds the POSTs
    gate.set()
    assert pub.drain(timeout=WAIT)
    assert done == [0, 1, 2] and pub.published == 9 and pub.pending == 0
    assert [b["reports"][0]["id"] for b in bodies] == [11, 12, 13]
    pub.close()
    pub.close()                                # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pub.publish_columns(*_report_cols())


# ---------------------------------------------------------------------------
# The pipelined flush (tests/test_pipelined_flush.py), on gated stand-ins


class GateMatcher:
    """match_many stand-in: blocks on ``gate`` (held open by default),
    then emits one complete SegmentRecord per trace; ``entered`` is set
    on every call."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.calls = 0

    def __call__(self, traces):
        self.calls += 1
        self.entered.set()
        assert self.gate.wait(WAIT), "test gate never released"
        out = []
        for t in traces:
            t0 = float(t.times[0]) if len(t.times) else 0.0
            t1 = float(t.times[-1]) if len(t.times) else 1.0
            out.append([SegmentRecord(segment_id=7001, way_ids=[1],
                                      start_time=t0,
                                      end_time=max(t1, t0 + 0.5),
                                      length=50.0, internal=False)])
        return out


class GateTransport:
    """Datastore stand-in: blocks on ``gate``, keeps the bodies."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.bodies: list = []
        self._lock = threading.Lock()

    def __call__(self, url, body):
        assert self.gate.wait(WAIT), "test gate never released"
        with self._lock:
            self.bodies.append(json.loads(body))
        return 200

    def reports(self):
        with self._lock:
            return [r for p in self.bodies for r in p.get("reports", [])]


_GATED = dict(flush_max_age=1e9, poll_max_records=1000,
              hist_flush_interval=0.0, pipeline_depth=1)


def _mk_pipe(tiles, transport, **stream_kw):
    cfg = Config(service=ServiceConfig(datastore_url=URL),
                 streaming=StreamingConfig(**{**_GATED, **stream_kw}))
    clock = FakeClock()
    pipe = ColumnarStreamPipeline(tiles, cfg, transport=transport,
                                  clock=clock, device="cpu")
    matcher = GateMatcher()
    pipe.matcher.match_many = matcher
    return pipe, clock, matcher


def _recs(uuid, times):
    return [{"uuid": uuid, "lat": 37.7749 + 1e-5 * t, "lon": -122.4194,
             "time": float(t)} for t in times]


def _spin(pipe, predicate, steps=100):
    """Step until predicate(stats); between steps wait (bounded) for the
    in-flight waves and the publisher, so every step sees progress."""
    for _ in range(steps):
        pipe.step()
        st = pipe.stats()
        if predicate(st):
            return st
        _settle(pipe)
        pipe.publisher.drain(timeout=WAIT)
    raise AssertionError(f"condition never reached; stats={pipe.stats()}")


class TestOverlap:
    def test_step_returns_while_match_in_flight(self, tiles):
        tr = GateTransport()
        pipe, _, matcher = _mk_pipe(tiles, tr, flush_min_points=4)
        pipe.queue.append_many(_recs("veh-a", range(6)))
        matcher.gate.clear()                       # hold the wave "on card"
        assert pipe.step() == 0
        assert matcher.entered.wait(WAIT)          # the match thread got it
        st = pipe.stats()
        assert st["inflight_waves"] == 1 and matcher.calls == 1
        assert pipe.committed != pipe._consumed and min(pipe.committed) == 0
        # consume continues; the busy uuid is not flushed again
        pipe.queue.append_many(_recs("veh-a", range(6, 12)))
        pipe.step()
        assert pipe.stats()["buffered_points"] == 6 and matcher.calls == 1
        matcher.gate.set()
        _spin(pipe, lambda s: s["inflight_waves"] == 0 and s["reports"] >= 2)
        pipe.drain()
        assert pipe.stats()["buffered_points"] == 0
        assert pipe.committed == pipe._consumed
        assert len(tr.reports()) == pipe.stats()["reports"] == 2
        pipe.close()

    def test_depth_one_never_two_waves_in_flight(self, tiles):
        pipe, _, matcher = _mk_pipe(tiles, GateTransport(),
                                    flush_min_points=2)
        matcher.gate.clear()
        pipe.queue.append_many(_recs("veh-a", range(3)))
        pipe.step()
        assert matcher.entered.wait(WAIT)
        pipe.queue.append_many(_recs("veh-b", range(3)))
        pipe.step()                                # veh-b ripe, depth 1
        assert pipe.stats()["inflight_waves"] == 1 and matcher.calls == 1
        matcher.gate.set()
        _spin(pipe, lambda s: s["reports"] >= 2 and s["inflight_waves"] == 0)
        assert matcher.calls == 2
        pipe.drain()
        pipe.close()

    def test_publish_pending_holds_commit_floor(self, tiles):
        tr = GateTransport()
        pipe, _, _ = _mk_pipe(tiles, tr, flush_min_points=3)
        pipe.queue.append_many(_recs("veh-a", range(4)))
        tr.gate.clear()                            # stall the POST
        st = _spin(pipe, lambda s: s["publish_pending"] == 1)
        assert st["inflight_waves"] == 0
        assert min(pipe.committed) == 0 and pipe.committed != pipe._consumed
        tr.gate.set()
        assert pipe.publisher.drain(timeout=WAIT)
        pipe.step()
        assert pipe.committed == pipe._consumed
        assert pipe.stats()["publish_pending"] == 0 and len(tr.reports()) == 1
        pipe.close()

    def test_crash_with_wave_in_flight_replays(self, tiles):
        tr = GateTransport()
        pipe, _, _ = _mk_pipe(tiles, tr, flush_min_points=3)
        queue = pipe.queue
        queue.append_many(_recs("veh-a", range(4)))
        tr.gate.clear()
        _spin(pipe, lambda s: s["publish_pending"] == 1)
        committed = list(pipe.committed)
        assert min(committed) == 0
        tr2 = GateTransport()
        pipe2, _, _ = _mk_pipe(tiles, tr2, flush_min_points=3)
        pipe2.queue = queue
        pipe2._consumed = list(committed)
        pipe2.committed = list(committed)
        _spin(pipe2, lambda s: s["reports"] >= 1)
        pipe2.drain()
        assert len(tr2.reports()) == 1             # the wave, replayed
        tr.gate.set()                              # release the zombie
        assert pipe.publisher.drain(timeout=WAIT)
        pipe.close()
        pipe2.close()

    def test_checkpoint_is_a_consistent_cut(self, tiles, tmp_path):
        tr = GateTransport()
        pipe, _, matcher = _mk_pipe(tiles, tr, flush_min_points=3)
        pipe.queue.append_many(_recs("veh-a", range(4)))
        matcher.gate.clear()
        pipe.step()
        assert matcher.entered.wait(WAIT)
        assert pipe.stats()["inflight_waves"] == 1
        threading.Thread(target=matcher.gate.set).start()
        pipe.checkpoint(str(tmp_path / "cut.npz"))   # joins the wave
        assert pipe.committed == pipe._consumed
        assert len(tr.reports()) == 1
        pipe.close()

    def test_completion_failure_releases_wave_for_retry(self, tiles):
        tr = GateTransport()
        pipe, _, _ = _mk_pipe(tiles, tr, flush_min_points=3)
        real = pipe._reports_from_records
        boom = {"armed": True}

        def flaky(per_trace, wave):
            if boom["armed"]:
                boom["armed"] = False
                raise IndexError("unexpected result shape")
            return real(per_trace, wave)

        pipe._reports_from_records = flaky
        pipe.queue.append_many(_recs("veh-a", range(4)))
        with pytest.raises(IndexError):
            _spin(pipe, lambda s: False)
        assert min(pipe.committed) == 0            # floor still held
        _spin(pipe, lambda s: s["reports"] >= 1)
        pipe.drain()
        assert pipe.committed == pipe._consumed and len(tr.reports()) == 1
        pipe.close()

    def test_matcher_failure_releases_wave_for_retry(self, tiles):
        tr = GateTransport()
        pipe, _, matcher = _mk_pipe(tiles, tr, flush_min_points=3)
        boom = {"armed": True}

        def flaky(traces):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("transient device failure")
            return matcher(traces)

        pipe.matcher.match_many = flaky
        pipe.queue.append_many(_recs("veh-a", range(4)))
        with pytest.raises(RuntimeError):
            _spin(pipe, lambda s: False)
        assert min(pipe.committed) == 0
        _spin(pipe, lambda s: s["reports"] >= 1)
        pipe.drain()
        assert len(tr.reports()) == 1 and pipe.committed == pipe._consumed
        pipe.close()

    def test_timeless_stamps_rebased_on_failed_wave(self, tiles):
        pipe, _, matcher = _mk_pipe(tiles, GateTransport(),
                                    flush_min_points=4)
        seen = []
        boom = {"armed": True}

        def flaky(traces):
            out = matcher(traces)                  # waits on matcher.gate
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("transient failure")
            seen.append([t.times.copy() for t in traces])
            return out

        pipe.matcher.match_many = flaky
        timeless = lambda n: [{"uuid": "veh-a", "lat": 37.7749,  # noqa: E731
                               "lon": -122.4194} for _ in range(n)]
        pipe.queue.append_many(timeless(4))
        matcher.gate.clear()
        pipe.step()                                # stamps 0..3 in flight
        pipe.queue.append_many(timeless(3))
        pipe.step()                                # arrivals stamped 0..2
        matcher.gate.set()
        with pytest.raises(RuntimeError):
            _spin(pipe, lambda s: False)
        L = pipe._log
        assert sorted(L.time[:L.n].tolist()) == [float(i) for i in range(7)]
        _spin(pipe, lambda s: s["reports"] >= 1)
        pipe.drain()
        assert [t.tolist() for t in seen[0]] == [list(range(7))]
        pipe.close()

    def test_pipeline_skips_and_counts_overrun(self, tiles):
        cfg = Config(service=ServiceConfig(datastore_url=URL),
                     streaming=StreamingConfig(flush_min_points=4, **_GATED))
        queue = ColumnarIngestQueue(cfg.streaming.num_partitions,
                                    max_records_per_partition=8,
                                    overload_policy="drop_oldest")
        pipe = ColumnarStreamPipeline(tiles, cfg, queue=queue,
                                      transport=GateTransport(),
                                      device="cpu")
        pipe.matcher.match_many = GateMatcher()
        for k in range(6):
            queue.append_columns(pack_records(_recs("veh-a",
                                                    range(4 * k, 4 * k + 4))))
        assert queue.overload_stats()["broker_dropped_oldest"] > 0
        _spin(pipe, lambda s: s["reports"] >= 1)
        pipe.drain()
        st = pipe.stats()
        assert st["overrun"] == \
            queue.overload_stats()["broker_dropped_oldest"] > 0
        assert st["lag"] == 0
        pipe.close()

    def test_poison_transport_does_not_wedge_worker(self, tiles):
        calls = {"n": 0}

        def bad_then_good(url, body):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("unknown url type")
            return 200

        pipe, _, _ = _mk_pipe(tiles, bad_then_good, flush_min_points=3)
        pipe.queue.append_many(_recs("veh-a", range(4)))
        _spin(pipe, lambda s: s["publish_pending"] == 0
              and s["publish_dropped"] == 1)
        assert pipe.committed == pipe._consumed
        pipe.queue.append_many(_recs("veh-a", range(4, 8)))
        _spin(pipe, lambda s: s["reports"] >= 2)
        pipe.drain()
        assert pipe.publisher.published > 0
        pipe.close()

    def test_direct_columnar_nonfinite(self, tiles):
        pipe, _, _ = _mk_pipe(tiles, GateTransport(), flush_min_points=100)
        pipe.queue.append_columns(ProbeColumns(
            np.array(["a", "a", "a", "a", "b"]), np.full(5, 37.0),
            np.full(5, -122.0), np.array([0.0, np.inf, -np.inf, np.nan, 1.0]),
            np.array([np.nan, np.nan, np.nan, np.nan, np.inf], np.float32)))
        pipe.step()
        st = pipe.stats()
        assert st["malformed"] == 2 and st["buffered_points"] == 3
        assert np.isnan(pipe._log.acc[:pipe._log.n]).all()
        pipe.close()


class TestWaveController:
    def test_grows_under_rising_lag_to_ceiling(self):
        ctl = _WaveController(start=120, lo=40, hi=960, target_s=2.0)
        lag, prev, pts = 5_000, 0, 120
        for _ in range(40):
            pts = ctl.update(lag, prev, 0.5)
            prev, lag = lag, int(lag * 1.2) + 10_000
        assert pts == 960

    def test_converges_below_latency_target_when_caught_up(self):
        ctl = _WaveController(start=960, lo=40, hi=960, target_s=2.0)
        pts = 960
        for _ in range(200):
            p50 = pts / 120.0
            new = ctl.update(5_000, 5_000, p50)
            if p50 <= 2.0:
                assert new == pts
                break
            pts = new
        else:
            raise AssertionError("never converged")
        assert pts <= 240

    def test_floor_clamp_and_jitter(self):
        ctl = _WaveController(start=100, lo=40, hi=960, target_s=0.001)
        for _ in range(100):
            pts = ctl.update(0, 0, 10.0)
        assert pts == 40
        ctl = _WaveController(start=120, lo=40, hi=960, target_s=2.0)
        for k in range(50):
            pts = ctl.update(1_000_000 + (k % 2), 1_000_000 - (k % 2), 1.0)
        assert pts == 120
