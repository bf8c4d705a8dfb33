"""The port's streaming worker (reporter_tpu_torch/streaming/) against the
JAX package's, on the CPU: the dict pipeline, the brokers, the histogram,
the checkpoint, the formatter and the native streaming functions.

Parity, tolerance 0: the same record stream, built with numpy from a
seed, goes in rounds through the JAX ``StreamPipeline`` (dense
candidates: on a CPU backend "auto" would take the grid backend) and the
port's ``StreamPipeline(..., device="cpu")`` on the same tile arrays,
each with a fake clock; the published bodies (captured by a
``transport=`` function, histogram flushes included), both histograms,
``committed`` and ``malformed`` must be equal. A checkpoint and a broker
directory written by either package open in the other.

Then the JAX package's streaming tests (tests/test_streaming.py,
test_broker_contract.py without the kafka case, test_formatter.py) on
the port's modules, the ``checkpoint`` and ``broker`` fault sites, and
``build_reports`` / ``tail_cuts`` against their numpy forms and the JAX
package's native forms.
"""

import json
import os
import time

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.matcher import native_prepare as jnp_prepare
from reporter_tpu.matcher.native_walk import RecordColumns as JRecordColumns
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_probe
from reporter_tpu.streaming import StreamPipeline as JStreamPipeline
from reporter_tpu.streaming.durable_queue import (
    DurableIngestQueue as JDurableIngestQueue)
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch import faults
from reporter_tpu_torch.config import (Config, ServiceConfig,
                                       StreamingConfig)
from reporter_tpu_torch.matcher import native_prepare as npp
from reporter_tpu_torch.matcher.native_walk import RecordColumns
from reporter_tpu_torch.netgen import traces as ptraces
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.streaming import (IngestQueue, ProbeConsumer,
                                          ProbeFormatter, SpeedHistogram,
                                          StreamPipeline, StreamWorker)
from reporter_tpu_torch.streaming.columnar import build_report_columns
from reporter_tpu_torch.streaming.durable_queue import DurableIngestQueue
from reporter_tpu_torch.streaming.queue import partition_of
from reporter_tpu_torch.streaming.state import save_checkpoint
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils import tracing

pytestmark = pytest.mark.usefixtures("few_torch_threads")

URL = "http://ds.test/"
WAIT = 30.0        # the bound of every wait on a worker thread (s)


@pytest.fixture(scope="module")
def jtiles():
    """The JAX streaming tests' tile (tests/test_streaming.py)."""
    return compile_network(
        generate_city("tiny"),
        JCompilerParams(reach_radius=500.0, osmlr_max_length=200.0))


@pytest.fixture(scope="module")
def stream_tiles(jtiles):
    return TileSet.from_arrays(jtiles.name, jtiles.meta.origin_lonlat,
                               {f: getattr(jtiles, f) for f in _ARRAY_FIELDS})


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _records(probes):
    """Interleave probes' points into a single firehose (round-robin)."""
    out = []
    T = max(len(p.times) for p in probes)
    for t in range(T):
        for p in probes:
            if t < len(p.times):
                out.append({"uuid": p.uuid, "lat": float(p.lonlat[t, 1]),
                            "lon": float(p.lonlat[t, 0]),
                            "time": float(p.times[t])})
    return out


def _capture(sink):
    return lambda url, body: sink.append(json.loads(body)) or 200


def _pipeline(tiles, **stream_kw):
    published = []
    cfg = Config(service=ServiceConfig(datastore_url=URL),
                 streaming=StreamingConfig(**stream_kw))
    clock = FakeClock()
    pipe = StreamPipeline(tiles, cfg, transport=_capture(published),
                          clock=clock, device="cpu")
    return pipe, published, clock


def _jpipeline(jtiles, **stream_kw):
    published = []
    cfg = JConfig(matcher=JMatcherParams(candidate_backend="dense"),
                  service=JServiceConfig(datastore_url=URL),
                  streaming=JStreamingConfig(**stream_kw))
    clock = FakeClock()
    pipe = JStreamPipeline(jtiles, cfg, transport=_capture(published),
                           clock=clock)
    return pipe, published, clock


def _stream(jtiles, seed, n=6, points=48):
    """A record stream from a seed: n vehicles' synthetic probes,
    interleaved, with numpy-drawn accuracies on some records, one timeless
    vehicle and three poison records."""
    rng = np.random.default_rng(seed)
    probes = [synthesize_probe(jtiles, seed=int(s), num_points=points,
                               gps_sigma=3.0)
              for s in rng.integers(0, 10_000, n)]
    recs = _records(probes)
    acc = rng.uniform(2.0, 30.0, len(recs))
    for i, r in enumerate(recs):
        if r["uuid"] == probes[1].uuid:
            del r["time"]
        elif rng.random() < 0.2:
            r["accuracy"] = float(acc[i])
    for at in sorted(rng.choice(len(recs), 3, replace=False))[::-1]:
        recs.insert(int(at), {"uuid": "poison", "lat": "x", "lon": 1.0})
    return recs


def _feed(pipe, clock, recs, rounds):
    for chunk in np.array_split(np.arange(len(recs)), rounds):
        pipe.queue.append_many([recs[i] for i in chunk])
        pipe.step()
        clock.now += 2.0
    pipe.drain()


# ---------------------------------------------------------------------------
# Parity with the JAX package


class TestParityWithJax:
    @pytest.mark.parametrize("seed,rounds", [(3, 6), (11, 4)])
    def test_dict_pipeline_bodies_histograms_committed(
            self, jtiles, stream_tiles, seed, rounds):
        recs = _stream(jtiles, seed)
        kw = dict(flush_min_points=12, flush_max_age=5.0,
                  poll_max_records=64, hist_flush_interval=5.0)
        jp, jpub, jclock = _jpipeline(jtiles, **kw)
        pp, ppub, pclock = _pipeline(stream_tiles, **kw)
        _feed(jp, jclock, recs, rounds)
        _feed(pp, pclock, recs, rounds)
        for pipe in (jp, pp):
            pipe.flush_histograms()
        assert ppub == jpub
        assert any(b.get("reports") for b in ppub)
        assert any("histograms" in b for b in ppub)
        np.testing.assert_array_equal(pp.hist.snapshot(), jp.hist.snapshot())
        np.testing.assert_array_equal(pp.qhist.snapshot(),
                                      jp.qhist.snapshot())
        assert pp.committed == jp.committed
        assert pp.malformed == jp.malformed == 3
        assert pp.stats()["lag"] == 0

    def test_checkpoints_cross_restore_both_ways(self, jtiles, stream_tiles,
                                                 tmp_path):
        """A checkpoint written by the JAX worker restores into the
        port's and the other way round: the npz keys and dtypes agree,
        and the two continue the stream to equal bodies."""
        recs = _stream(jtiles, 5)
        half = len(recs) // 2
        kw = dict(flush_min_points=12, flush_max_age=1e9,
                  poll_max_records=10_000, hist_flush_interval=0.0)
        jp, _, _ = _jpipeline(jtiles, **kw)
        pp, _, _ = _pipeline(stream_tiles, **kw)
        for pipe in (jp, pp):
            pipe.queue.append_many(recs[:half])
            pipe.step()
        jp.checkpoint(str(tmp_path / "jax"))
        pp.checkpoint(str(tmp_path / "port"))
        with np.load(tmp_path / "jax.npz") as a, \
                np.load(tmp_path / "port.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                if k != "state":           # saved_at and cache ages differ
                    np.testing.assert_array_equal(a[k], b[k])
            sa = json.loads(bytes(a["state"]).decode())
            sb = json.loads(bytes(b["state"]).decode())
            assert sa["committed"] == sb["committed"]
            assert {u: e["points"] for u, e in sa["cache"].items()} == \
                {u: e["points"] for u, e in sb["cache"].items()}
        # swap: the JAX checkpoint into a fresh port pipeline and back
        p2, ppub, _ = _pipeline(stream_tiles, **kw)
        j2, jpub, _ = _jpipeline(jtiles, **kw)
        p2.restore(str(tmp_path / "jax"))
        j2.restore(str(tmp_path / "port"))
        np.testing.assert_array_equal(p2.hist.snapshot(), j2.hist.snapshot())
        assert p2.committed == j2.committed
        for pipe in (p2, j2):
            pipe.queue.append_many(recs)     # the log outlives the worker
            pipe.step()
            pipe.drain()
        assert ppub == jpub and ppub
        np.testing.assert_array_equal(p2.hist.snapshot(), j2.hist.snapshot())
        np.testing.assert_array_equal(p2.qhist.snapshot(),
                                      j2.qhist.snapshot())

    def test_durable_record_broker_between_packages(self, jtiles, tmp_path):
        """A record broker directory written by either package opens in
        the other: same offsets, same records, the same bytes on disk."""
        recs = _stream(jtiles, 8, n=3, points=10)
        recs[4]["_trace"] = {"id": "t-1", "ts": 1.5}
        a, b = str(tmp_path / "jax"), str(tmp_path / "port")
        jq = JDurableIngestQueue(a, num_partitions=3)
        pq = DurableIngestQueue(b, num_partitions=3)
        for r in recs:
            jq.append(r)
            pq.append(r)
        jq.truncate([1, 0, 2])
        pq.truncate([1, 0, 2])
        jq.close()
        pq.close()
        for name in sorted(os.listdir(a)):
            with open(os.path.join(a, name), "rb") as f1, \
                    open(os.path.join(b, name), "rb") as f2:
                assert f1.read() == f2.read(), name
        pq2 = DurableIngestQueue(a, num_partitions=3)     # JAX-written
        jq2 = JDurableIngestQueue(b, num_partitions=3)    # port-written
        for p in range(3):
            assert pq2.end_offset(p) == jq2.end_offset(p)
            assert pq2.retention_floor(p) == jq2.retention_floor(p)
            lo = pq2.retention_floor(p)
            assert pq2.poll(p, lo, 1000) == jq2.poll(p, lo, 1000)
        pq2.append(recs[0])                # the port appends to a JAX log
        pq2.close()
        jq3 = JDurableIngestQueue(a, num_partitions=3)
        p0 = partition_of(recs[0]["uuid"], 3)
        assert jq3.poll(p0, jq3.end_offset(p0) - 1, 5)[0][1] == recs[0]
        jq2.close()
        jq3.close()

    def test_partition_of_is_the_jax_hash(self):
        from reporter_tpu.streaming.queue import partition_of as jpart

        rng = np.random.default_rng(2)
        for u in [f"veh-{i}" for i in rng.integers(0, 10**9, 200)] + [""]:
            for n in (1, 3, 4, 16):
                assert partition_of(u, n) == jpart(u, n)


# ---------------------------------------------------------------------------
# The JAX package's streaming tests on the port


class TestQueue:
    def test_offsets_and_poll(self):
        q = IngestQueue(num_partitions=2)
        q.append_many([{"uuid": f"v{i}", "x": i} for i in range(10)])
        assert sum(q.end_offset(p) for p in range(2)) == 10
        p = partition_of("v0", 2)
        got = q.poll(p, 0, 100)
        assert [o for o, _ in got] == list(range(len(got)))
        assert all(partition_of(r["uuid"], 2) == p for _, r in got)

    def test_replay_is_nondestructive(self):
        q = IngestQueue(num_partitions=1)
        q.append_many([{"uuid": "v", "i": i} for i in range(5)])
        assert q.poll(0, 0, 10) == q.poll(0, 0, 10)
        assert [r["i"] for _, r in q.poll(0, 3, 10)] == [3, 4]

    def test_truncate_enforces_retention(self):
        q = IngestQueue(num_partitions=1)
        q.append_many([{"uuid": "v", "i": i} for i in range(5)])
        q.truncate([3])
        with pytest.raises(LookupError):
            q.poll(0, 2, 10)
        assert [r["i"] for _, r in q.poll(0, 3, 10)] == [3, 4]

    def test_lag(self):
        q = IngestQueue(num_partitions=2)
        q.append_many([{"uuid": f"v{i}"} for i in range(6)])
        assert q.lag([0, 0]) == 6

    def test_reject_policy_returns_minus_one(self):
        q = IngestQueue(1, max_records_per_partition=2,
                        overload_policy="reject")
        assert q.append({"uuid": "v", "lat": 1.0, "lon": 2.0})[1] == 0
        assert q.append({"uuid": "v", "lat": 1.0, "lon": 2.0})[1] == 1
        assert q.append({"uuid": "v", "lat": 1.0, "lon": 2.0})[1] == -1
        assert q.overload_stats()["broker_rejected"] == 1


class TestSpeedHistogram:
    def test_matches_numpy(self):
        rng = np.random.default_rng(0)
        edges = (0.0, 5.0, 10.0, 20.0)
        h = SpeedHistogram(num_rows=16, bin_edges=edges, device="cpu")
        want = np.zeros((16, 4), np.int64)
        for _ in range(4):                       # updates accumulate
            n = int(rng.integers(1, 200))
            rows = rng.integers(-3, 20, n).astype(np.int32)
            speeds = rng.uniform(-5, 30, n)
            h.update(rows, speeds)
            bins = np.searchsorted(edges, speeds, side="right") - 1
            ok = (rows >= 0) & (rows < 16) & (bins >= 0)
            np.add.at(want, (rows[ok], bins[ok]), 1)
        assert h.snapshot().dtype == np.int32
        np.testing.assert_array_equal(h.snapshot(), want)
        np.testing.assert_array_equal(h.nonzero_rows(),
                                      np.nonzero(want.sum(axis=1))[0])

    def test_ignores_invalid_rows(self):
        h = SpeedHistogram(num_rows=4, bin_edges=(0.0, 10.0), device="cpu")
        h.update(np.array([-1, 99, 2], np.int32), np.array([5.0, 5.0, 5.0]))
        assert h.snapshot().sum() == 1 and h.snapshot()[2, 0] == 1

    def test_snapshot_and_load_are_copies(self):
        h = SpeedHistogram(num_rows=3, bin_edges=(0.0, 1.0), device="cpu")
        base = np.zeros((3, 2), np.int32)
        h.load(base)
        snap = h.snapshot()
        h.update(np.array([1], np.int32), np.array([2.0]))
        assert base.sum() == 0 and snap.sum() == 0
        assert h.snapshot()[1, 1] == 1

    def test_equals_jax_histogram(self):
        from reporter_tpu.streaming.histogram import (
            SpeedHistogram as JSpeedHistogram)

        rng = np.random.default_rng(4)
        edges = (0.0, 2.5, 5.0, 10.0, 40.0)
        jh = JSpeedHistogram(40, edges)
        ph = SpeedHistogram(40, edges, device="cpu")
        for _ in range(3):
            n = int(rng.integers(1, 5000))
            rows = rng.integers(-5, 45, n).astype(np.int32)
            speeds = rng.uniform(-2, 60, n)
            jh.update(rows, speeds)
            ph.update(rows, speeds)
        np.testing.assert_array_equal(ph.snapshot(), jh.snapshot())

    def test_cuda_without_a_card_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SpeedHistogram(4, (0.0, 1.0))


class TestPipeline:
    def test_firehose_end_to_end(self, stream_tiles):
        probes = [ptraces.synthesize_probe(stream_tiles, seed=40 + i, num_points=120,
                                   gps_sigma=3.0) for i in range(4)]
        pipe, published, clock = _pipeline(stream_tiles, flush_min_points=32)
        pipe.queue.append_many(_records(probes))
        while pipe.queue.lag(pipe.committed) > 0:
            pipe.step()
            clock.now += 1.0
        pipe.drain()
        got_ids = {r["id"] for batch in published for r in batch["reports"]}
        # oracle: whole traces through the HTTP app (same matcher/config)
        app = make_app(stream_tiles, Config(), device="cpu")
        want_ids = set()
        for p in probes:
            want_ids |= {r["id"] for r in
                         app.report_one(p.to_report_json())["reports"]}
        assert want_ids <= got_ids
        assert len(pipe.hist.nonzero_rows()) > 0
        assert pipe.stats()["lag"] == 0

    def test_age_based_flush(self, stream_tiles):
        probe = ptraces.synthesize_probe(stream_tiles, seed=50, num_points=10)
        pipe, _, clock = _pipeline(stream_tiles, flush_min_points=1000,
                                   flush_max_age=5.0)
        pipe.queue.append_many(_records([probe]))
        pipe.step()
        assert pipe.stats()["buffered_points"] == 10
        clock.now += 10.0
        pipe.step()                                    # age forces the flush
        assert pipe.stats()["buffered_points"] == 0

    def test_committed_held_back_by_buffer(self, stream_tiles):
        probe = ptraces.synthesize_probe(stream_tiles, seed=51, num_points=10)
        pipe, _, _ = _pipeline(stream_tiles, flush_min_points=1000,
                               num_partitions=1)
        pipe.queue.append_many(_records([probe]))
        pipe.step()
        assert pipe.committed == [0]
        assert pipe.queue.lag(pipe.committed) == 10

    def test_crash_recovery_loses_nothing(self, stream_tiles, tmp_path):
        probes = [ptraces.synthesize_probe(stream_tiles, seed=60 + i, num_points=120,
                                   gps_sigma=3.0) for i in range(2)]
        recs = _records(probes)
        ckpt = str(tmp_path / "pipe.npz")
        pipe_a, pub_a, _ = _pipeline(stream_tiles, flush_min_points=32)
        pipe_a.queue.append_many(recs[:len(recs) // 2])
        pipe_a.step()
        pipe_a.checkpoint(ckpt)
        n_at_ckpt = len(pub_a)
        pipe_a.queue.append_many(recs[len(recs) // 2:])
        pipe_a.step()

        def run(restore):
            pipe, pub, clock = _pipeline(stream_tiles, flush_min_points=32)
            pipe.queue.append_many(recs)
            if restore:
                pipe.restore(ckpt)
            while pipe.queue.lag(pipe.committed) > 0:
                pipe.step()
                clock.now += 1.0
            pipe.drain()
            return {r["id"] for b in pub for r in b["reports"]}

        ids_a = {r["id"] for b in pub_a[:n_at_ckpt] for r in b["reports"]}
        assert run(restore=False) <= ids_a | run(restore=True)

    def test_poison_record_does_not_stall_partition(self, stream_tiles):
        pipe, _, _ = _pipeline(stream_tiles, num_partitions=1,
                               flush_min_points=1000)
        pipe.queue.append_many([
            {"uuid": "v", "lat": None, "lon": 1.0},
            {"uuid": "v", "lat": "nope", "lon": 1.0},
            {"uuid": "v", "lat": 37.77, "lon": -122.45, "time": 1.0}])
        pipe.step()
        assert pipe.malformed == 2
        assert pipe.stats()["buffered_points"] == 1
        assert pipe.queue.lag(pipe._consumed) == 0

    def test_flush_failure_keeps_buffers_and_commit_floor(self,
                                                          stream_tiles):
        probe = ptraces.synthesize_probe(stream_tiles, seed=80, num_points=20)
        pipe, _, _ = _pipeline(stream_tiles, num_partitions=1,
                               flush_min_points=4)
        pipe.queue.append_many(_records([probe]))
        boom = RuntimeError("transient device error")
        orig = pipe.app.report_many
        pipe.app.report_many = lambda p: (_ for _ in ()).throw(boom)
        with pytest.raises(RuntimeError):
            pipe.step()
        assert pipe.stats()["buffered_points"] == 20
        pipe._commit()
        assert pipe.committed == [0]
        pipe.app.report_many = orig
        pipe.step(force_flush=True)
        assert pipe.stats()["buffered_points"] == 0
        assert pipe.committed == [20]

    def test_restore_honors_cache_ttl(self, stream_tiles, tmp_path,
                                      monkeypatch):
        probe = ptraces.synthesize_probe(stream_tiles, seed=81, num_points=40)
        pipe, _, _ = _pipeline(stream_tiles, flush_min_points=8)
        pipe.queue.append_many(_records([probe]))
        while pipe.queue.lag(pipe.committed) > 0:
            pipe.step()
        assert len(pipe.app.cache) > 0
        ckpt = str(tmp_path / "ttl")                     # no suffix
        pipe.checkpoint(ckpt)
        fresh, _, _ = _pipeline(stream_tiles)
        fresh.restore(ckpt)
        assert len(fresh.app.cache) > 0
        real = time.time()
        monkeypatch.setattr(time, "time", lambda: real + 10_000.0)
        late, _, _ = _pipeline(stream_tiles)
        late.restore(ckpt)
        assert len(late.app.cache) == 0

    def test_checkpoint_restores_histogram(self, stream_tiles, tmp_path):
        probe = ptraces.synthesize_probe(stream_tiles, seed=70, num_points=120,
                                 gps_sigma=3.0)
        pipe, _, _ = _pipeline(stream_tiles, flush_min_points=16)
        pipe.queue.append_many(_records([probe]))
        while pipe.queue.lag(pipe.committed) > 0:
            pipe.step()
        pipe.drain()
        snap = pipe.hist.snapshot()
        assert snap.sum() > 0
        ckpt = str(tmp_path / "h.npz")
        pipe.checkpoint(ckpt)
        pipe2, _, _ = _pipeline(stream_tiles)
        pipe2.restore(ckpt)
        np.testing.assert_array_equal(pipe2.hist.snapshot(), snap)

    def test_stream_ingest_keeps_accuracy(self, stream_tiles):
        pipe, _, _ = _pipeline(stream_tiles)
        pipe.queue.append({"uuid": "v", "lat": 37.75, "lon": -122.41,
                           "time": 0.0, "accuracy": 25.0})
        pipe.queue.append({"uuid": "v", "lat": 37.7501, "lon": -122.41,
                           "time": 1.0, "accuracy": "garbage"})
        pipe.step()
        pts = pipe._buffers["v"].points
        assert pts[0]["accuracy"] == 25.0
        assert "accuracy" not in pts[1]

    def test_trace_ids_ride_the_worker_span(self, stream_tiles):
        tr = tracing.tracer()
        was = tr.enabled
        tr.configure(enabled=True)
        tr.clear()
        try:
            pipe, _, _ = _pipeline(stream_tiles, flush_min_points=4)
            for i in range(6):
                rec = {"uuid": "v", "lat": 37.75 + 1e-5 * i,
                       "lon": -122.41, "time": float(i)}
                if i % 2 == 0:
                    tracing.stamp_record(rec, f"v@{i}")
                pipe.queue.append(rec)
            pipe.step()
        finally:
            tr.configure(enabled=was)
        assert pipe.traced_records == 3
        spans = {s.name: s for s in tr.snapshot()}
        assert spans["worker_match"].args["traced"] == 3
        assert spans["worker_match"].args["trace_ids"] == [
            "v@0", "v@2", "v@4"]
        assert tracing.trace_id_of({"_trace": {"id": 7}}) == "7"
        assert tracing.trace_id_of({"_trace": "junk"}) is None

    def test_mesh_raises(self, stream_tiles):
        """The mesh arm (once refused naming ROADMAP item 7) builds the
        app's matcher over the mesh, the histograms on its first device;
        a mesh beside a device raises (tests/test_torch_parallel.py
        holds the mesh pipeline's bodies to the JAX package's)."""
        from reporter_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(dp=2, devices=["cpu"] * 2)
        pipe = StreamPipeline(stream_tiles, Config(), mesh=mesh)
        assert pipe.app.matcher.wire_mesh is mesh
        assert pipe.hist.device == mesh.flat_devices[0]
        with pytest.raises(ValueError, match="not both"):
            StreamPipeline(stream_tiles, Config(), mesh=mesh, device="cpu")


class TestConsumerGroup:
    def _two_workers(self, tiles):
        published = []
        cfg = Config(service=ServiceConfig(datastore_url=URL),
                     streaming=StreamingConfig(num_partitions=4,
                                               flush_min_points=16))
        clock = FakeClock()
        queue = IngestQueue(4)
        mk = lambda parts: StreamPipeline(      # noqa: E731
            tiles, cfg, queue=queue, transport=_capture(published),
            clock=clock, partitions=parts, device="cpu")
        return mk([0, 1]), mk([2, 3]), queue, published, clock

    def test_disjoint_partitions_drain_everything(self, stream_tiles):
        a, b, queue, published, _ = self._two_workers(stream_tiles)
        probes = [ptraces.synthesize_probe(stream_tiles, seed=s, num_points=60,
                                   gps_sigma=3.0) for s in range(6)]
        queue.append_many(_records(probes))
        for _ in range(8):
            a.step()
            b.step()
        a.drain()
        b.drain()
        for p in range(4):
            owner = a if p in a.partitions else b
            assert owner.committed[p] == queue.end_offset(p)
        assert published

    def test_rebalance_replays_dead_workers_tail(self, stream_tiles,
                                                 tmp_path):
        a, b, queue, _, clock = self._two_workers(stream_tiles)
        probes = [ptraces.synthesize_probe(stream_tiles, seed=10 + s, num_points=80,
                                   gps_sigma=3.0) for s in range(4)]
        recs = _records(probes)
        queue.append_many(recs[:len(recs) // 2])
        a.step()
        b.step()
        ckpt = str(tmp_path / "a.npz")
        a.checkpoint(ckpt)
        queue.append_many(recs[len(recs) // 2:])
        a2 = StreamPipeline(stream_tiles, a.config, queue=queue,
                            transport=a.app.publisher._transport,
                            clock=clock, partitions=[0, 1], device="cpu")
        a2.restore(ckpt)
        for _ in range(8):
            a2.step()
            b.step()
        a2.drain()
        b.drain()
        for p in (0, 1):
            assert a2.committed[p] == queue.end_offset(p)
        for p in (2, 3):
            assert b.committed[p] == queue.end_offset(p)

    def test_adopt_and_release_partition(self, stream_tiles):
        a, b, queue, _, _ = self._two_workers(stream_tiles)
        probes = [ptraces.synthesize_probe(stream_tiles, seed=20 + s, num_points=20,
                                   gps_sigma=3.0) for s in range(4)]
        queue.append_many(_records(probes))
        b.step()
        floor = list(b.committed)
        dropped = b.release_partition(2, flush=False)
        assert 2 not in b.partitions
        a.adopt_partition(2, floor[2])
        with pytest.raises(ValueError, match="already owned"):
            a.adopt_partition(2, 0)
        a.step(force_flush=True)
        b.step(force_flush=True)
        assert a.committed[2] == queue.end_offset(2)
        assert dropped == queue.end_offset(2) - floor[2]

    def test_worker_threads(self, stream_tiles):
        a, b, queue, _, _ = self._two_workers(stream_tiles)
        probes = [ptraces.synthesize_probe(stream_tiles, seed=30 + s, num_points=60,
                                   gps_sigma=3.0) for s in range(4)]
        wa, wb = StreamWorker(a).start(), StreamWorker(b).start()
        queue.append_many(_records(probes))
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and not all(
                pl.stats()["lag"] == 0 for pl in (a, b)):
            time.sleep(0.02)          # the workers' own poll interval
        wa.stop()
        wb.stop()
        assert not wa.alive and not wb.alive
        assert wa.errors == 0 and wb.errors == 0
        for p in range(4):
            owner = a if p in a.partitions else b
            assert owner.committed[p] == queue.end_offset(p)


class TestHistogramFlush:
    def test_periodic_delta_flush(self, stream_tiles):
        pipe, published, clock = _pipeline(stream_tiles, flush_min_points=16,
                                           hist_flush_interval=100.0)
        probes = [ptraces.synthesize_probe(stream_tiles, seed=90 + s, num_points=120,
                                   gps_sigma=3.0) for s in range(3)]
        pipe.queue.append_many(_records(probes))
        for _ in range(10):
            pipe.step()
        pipe.drain()
        assert pipe.hist.snapshot().sum() > 0
        before = pipe.hist_flushes
        clock.now += 101.0
        pipe.step()
        assert pipe.hist_flushes == before + 1
        hist_posts = [p for p in published if "histograms" in p]
        assert hist_posts
        seg_ids = {h["segment_id"] for p in hist_posts
                   for h in p["histograms"]}
        assert seg_ids <= {int(s) for s in stream_tiles.osmlr_id}
        total = sum(sum(h["counts"]) for p in hist_posts
                    for h in p["histograms"])
        assert total == int(pipe.hist.snapshot().sum())
        clock.now += 101.0
        pipe.step()
        assert pipe.hist_flushes == before + 1


# ---------------------------------------------------------------------------
# Brokers: the ProbeConsumer contract (tests/test_broker_contract.py)


def check_probe_consumer(consumer, produce, num_records: int = 40) -> None:
    """The ProbeConsumer offset semantics the pipelines rely on."""
    P = consumer.num_partitions
    assert P >= 1 and isinstance(consumer, ProbeConsumer)
    start = [consumer.end_offset(p) for p in range(P)]
    records = [{"uuid": f"veh-{i % 7}", "lat": float(i), "lon": -float(i),
                "time": float(i)} for i in range(num_records)]
    for r in records:
        produce(r)
    end = [consumer.end_offset(p) for p in range(P)]
    assert sum(end) - sum(start) == num_records
    for p in range(P):
        got = consumer.poll(p, start[p], max_records=10 ** 9)
        assert [off for off, _ in got] == list(range(start[p], end[p]))
        assert consumer.poll(p, start[p], max_records=3) == got[:3]
        assert consumer.poll(p, end[p], max_records=16) == []
        assert consumer.poll(p, start[p], 1000) == \
            consumer.poll(p, start[p], 1000)
    seen: dict = {}
    for p in range(P):
        for _, rec in consumer.poll(p, start[p], max_records=1000):
            part, times = seen.setdefault(rec["uuid"], (p, []))
            assert part == p
            times.append(rec["time"])
    for _, (_, times) in seen.items():
        assert times == sorted(times)


class TestBrokerContract:
    @pytest.mark.parametrize("parts", [4, 1])
    def test_ingest_queue(self, parts):
        q = IngestQueue(num_partitions=parts)
        check_probe_consumer(q, q.append)

    def test_durable_queue(self, tmp_path):
        q = DurableIngestQueue(str(tmp_path / "log"), num_partitions=4)
        check_probe_consumer(q, q.append)
        q.close()

    def test_columnar_queue_shim(self):
        from reporter_tpu_torch.streaming import ColumnarIngestQueue

        q = ColumnarIngestQueue(num_partitions=3)
        check_probe_consumer(q, q.append)

    def test_retention_floor_raises(self):
        q = IngestQueue(num_partitions=2)
        for i in range(10):
            q.append({"uuid": "v", "lat": 0.0, "lon": 0.0, "time": float(i)})
        q.truncate([q.end_offset(0), q.end_offset(1)])
        with pytest.raises(LookupError):
            q.poll(partition_of("v", 2), 0, max_records=4)

    def test_pipeline_accepts_any_probe_consumer(self, stream_tiles):
        class WrappedConsumer:
            def __init__(self, inner):
                self._inner = inner
                self.num_partitions = inner.num_partitions
                self.polls = 0

            def poll(self, partition, offset, max_records):
                self.polls += 1
                return self._inner.poll(partition, offset, max_records)

            def end_offset(self, partition):
                return self._inner.end_offset(partition)

        inner = IngestQueue(Config().streaming.num_partitions)
        wrapped = WrappedConsumer(inner)
        pipe = StreamPipeline(stream_tiles, Config(), queue=wrapped,
                              device="cpu")
        for i in range(20):
            inner.append({"uuid": "veh-a", "lat": 0.0, "lon": 0.0,
                          "time": float(i)})
        pipe.step(force_flush=True)
        assert wrapped.polls >= 1 and pipe.stats()["lag"] == 0


class TestDurableIngestQueue:
    def _fill(self, q, n, base=0):
        for i in range(base, base + n):
            q.append({"uuid": "v", "lat": float(i), "lon": 0.0,
                      "time": float(i)})

    def test_reopen_preserves_offsets_and_records(self, tmp_path):
        d = str(tmp_path / "log")
        q = DurableIngestQueue(d, num_partitions=2)
        for i in range(30):
            q.append({"uuid": f"v{i % 5}", "lat": float(i), "lon": 0.0,
                      "time": float(i)})
        want = [q.poll(p, 0, 1000) for p in range(2)]
        ends = [q.end_offset(p) for p in range(2)]
        q.close()
        q2 = DurableIngestQueue(d, num_partitions=2)
        assert [q2.end_offset(p) for p in range(2)] == ends
        assert [q2.poll(p, 0, 1000) for p in range(2)] == want

    def test_torn_tail_dropped_and_cut_from_disk(self, tmp_path):
        d = str(tmp_path / "log")
        q = DurableIngestQueue(d, num_partitions=1)
        self._fill(q, 5)
        q.close()
        with open(f"{d}/p0.log", "ab") as f:
            f.write(b'{"uuid": "v", "lat": 9')       # killed mid-write
        q2 = DurableIngestQueue(d, num_partitions=1)
        assert q2.end_offset(0) == 5
        self._fill(q2, 100, base=5)
        q2.close()
        q3 = DurableIngestQueue(d, num_partitions=1)
        assert q3.end_offset(0) == 105
        assert [r["time"] for _, r in q3.poll(0, 0, 200)] == [
            float(i) for i in range(105)]

    def test_truncate_is_atomic_with_content(self, tmp_path):
        d = str(tmp_path / "log")
        q = DurableIngestQueue(d, num_partitions=1)
        self._fill(q, 10)
        q.truncate([6])
        q.append({"uuid": "v", "lat": 10.0, "lon": 0.0, "time": 10.0})
        q.close()
        assert sorted(os.listdir(d)) == ["meta.json", "p0.log"]
        q2 = DurableIngestQueue(d, num_partitions=1)
        with pytest.raises(LookupError):
            q2.poll(0, 3, 10)
        assert [(off, r["time"]) for off, r in q2.poll(0, 6, 10)] == [
            (6, 6.0), (7, 7.0), (8, 8.0), (9, 9.0), (10, 10.0)]

    def test_crash_restart_replays_unflushed_tail(self, stream_tiles,
                                                  tmp_path):
        d, ckpt = str(tmp_path / "log"), str(tmp_path / "ckpt")
        cfg = Config()
        q = DurableIngestQueue(d, cfg.streaming.num_partitions)
        pipe = StreamPipeline(stream_tiles, cfg, queue=q, device="cpu")
        fleet = ptraces.synthesize_fleet(stream_tiles, 4, num_points=40, seed=9)
        records = [{"uuid": p.uuid, "lat": float(la), "lon": float(lo),
                    "time": float(t)}
                   for p in fleet for (lo, la), t in zip(p.lonlat, p.times)]
        for r in records[:80]:
            q.append(r)
        n1 = pipe.step(force_flush=True)
        pipe.checkpoint(ckpt)
        for r in records[80:]:
            q.append(r)
        pipe.step()
        q.close()
        del pipe, q                                   # the "crash"
        q2 = DurableIngestQueue(d, cfg.streaming.num_partitions)
        pipe2 = StreamPipeline(stream_tiles, cfg, queue=q2, device="cpu")
        pipe2.restore(ckpt)
        n2 = pipe2.drain()
        assert n1 > 0 and n2 > 0 and pipe2.stats()["lag"] == 0
        q2.close()

    def test_reopen_with_different_partition_count_rejected(self, tmp_path):
        d = str(tmp_path / "log")
        q = DurableIngestQueue(d, num_partitions=4)
        q.append({"uuid": "v", "lat": 0.0, "lon": 0.0, "time": 0.0})
        q.close()
        with pytest.raises(ValueError, match="num_partitions=4"):
            DurableIngestQueue(d, num_partitions=2)


# ---------------------------------------------------------------------------
# The checkpoint fault site


def test_checkpoint_crash_keeps_previous_snapshot(stream_tiles, tmp_path):
    pipe, _, _ = _pipeline(stream_tiles, flush_min_points=8)
    probe = ptraces.synthesize_probe(stream_tiles, seed=12, num_points=30,
                             gps_sigma=3.0)
    pipe.queue.append_many(_records([probe]))
    pipe.step()
    path = str(tmp_path / "c.npz")
    pipe.checkpoint(path)
    with open(path, "rb") as f:
        first = f.read()
    pipe.step(force_flush=True)
    with faults.use(faults.FaultPlan.parse("checkpoint:crash@0")) as plan:
        with pytest.raises(faults.InjectedCrash):
            pipe.checkpoint(path)
        assert plan.stats()["fired"]["checkpoint"] == 1
    with open(path, "rb") as f:
        assert f.read() == first                 # the old snapshot survives
    pipe.checkpoint(path)                        # no plan: the rename lands
    with open(path, "rb") as f:
        assert f.read() != first


@pytest.mark.parametrize("spec", ["broker:torn@0", "checkpoint:crash@1",
                                  "publish:fail@0-"])
def test_fault_plan_sites(spec):
    assert faults.FaultPlan.parse(spec).rules


@pytest.mark.parametrize("spec,match", [
    ("checkpoint:torn@0", "broker-site kind"),
    ("autotune:hang(1)@0", "unknown fault site")])
def test_fault_plan_rejects(spec, match):
    with pytest.raises(ValueError, match=match):
        faults.FaultPlan.parse(spec)


def test_save_checkpoint_schema(tmp_path):
    h = np.arange(6, dtype=np.int32).reshape(3, 2)
    save_checkpoint(str(tmp_path / "s"), [1, 2], {}, h, h * 0, h, h * 0)
    with np.load(tmp_path / "s.npz") as z:
        assert sorted(z.files) == ["hist", "hist_flushed", "qhist",
                                   "qhist_flushed", "state"]
        assert z["state"].dtype == np.uint8
        assert json.loads(bytes(z["state"]).decode())["committed"] == [1, 2]


# ---------------------------------------------------------------------------
# The formatter (tests/test_formatter.py)


class TestFormatter:
    def test_canonical_passthrough(self):
        rec = ProbeFormatter().normalize(
            {"uuid": "v1", "lat": 37.75, "lon": -122.4, "time": 5.0,
             "accuracy": 8.0})
        assert rec == {"uuid": "v1", "lat": 37.75, "lon": -122.4,
                       "time": 5.0, "accuracy": 8.0}

    @pytest.mark.parametrize("payload,want_uuid", [
        ({"vehicle_id": 77, "latitude": 1.0, "longitude": 2.0,
          "timestamp": 3.0}, "77"),
        ({"device_id": "d-9", "y": 1.0, "x": 2.0, "ts": 3.0}, "d-9"),
        ({"id": "n", "location": {"lat": 1.0, "lng": 2.0},
          "recorded_at": 3.0}, "n"),
    ])
    def test_vendor_aliases_and_nesting(self, payload, want_uuid):
        rec = ProbeFormatter().normalize(payload)
        assert (rec["uuid"], rec["lat"], rec["lon"], rec["time"]) == (
            want_uuid, 1.0, 2.0, 3.0)

    def test_csv_and_json_strings(self):
        f = ProbeFormatter()
        assert f.normalize("v2, 37.75, -122.40, 12.5, 6.0") == {
            "uuid": "v2", "lat": 37.75, "lon": -122.4, "time": 12.5,
            "accuracy": 6.0}
        assert f.normalize(b"v3,1.0,2.0") == {"uuid": "v3", "lat": 1.0,
                                              "lon": 2.0}
        assert f.normalize('{"uuid": "s", "lat": 1.5, "lon": 2.5, '
                           '"time": 0}') == {"uuid": "s", "lat": 1.5,
                                             "lon": 2.5, "time": 0.0}
        assert f.normalize("veh-1,37.75,-122.40,") == {
            "uuid": "veh-1", "lat": 37.75, "lon": -122.4}

    @pytest.mark.parametrize("bad", [
        None, 42, "", "not,a", '{"lat": 1.0}', {"uuid": "v"},
        {"uuid": "v", "lat": float("nan"), "lon": 1.0},
        {"uuid": "", "lat": 1.0, "lon": 1.0},
        b"\xff\xfe", "{broken json", "v,abc,def",
    ])
    def test_malformed_dropped_not_raised(self, bad):
        f = ProbeFormatter()
        assert f.normalize(bad) is None
        assert f.stats()["dropped"] == 1

    def test_aliases_and_pins(self):
        assert "accuracy" not in ProbeFormatter().normalize(
            {"uuid": "v", "lat": 1.0, "lon": 2.0, "accuracy": -4.0})
        assert ProbeFormatter().normalize(
            {"id": "v1", "lat": None, "latitude": 37.75,
             "lon": -122.4})["lat"] == 37.75
        assert ProbeFormatter().normalize(
            {"uuid": None, "id": "v1", "lat": 1.0, "lon": 2.0})["uuid"] == "v1"
        assert ProbeFormatter().normalize(
            {"uuid": None, "lat": 1.0, "lon": 2.0}) is None
        f = ProbeFormatter("json")
        assert f.normalize("veh-1,37.75,-122.40,5.0") is None
        with pytest.raises(ValueError, match="unknown format"):
            ProbeFormatter().normalize({"uuid": "v"}, fmt="jsonl")

    def test_registered_formats(self):
        f = ProbeFormatter()
        f.register("pipes", lambda s: {
            "uuid": s.split("|")[0], "lat": float(s.split("|")[1]),
            "lon": float(s.split("|")[2])})
        assert f.normalize("a|1.0|2.0", fmt="pipes") == {
            "uuid": "a", "lat": 1.0, "lon": 2.0}
        assert f.normalize("a|notanum|2.0", fmt="pipes") is None
        assert f.stats()["dropped"] == 1

    def test_partitioning_happens_after_normalization(self):
        q = IngestQueue(num_partitions=4)
        f = ProbeFormatter()
        raw = [{"uuid": "veh-x", "lat": 1.0, "lon": 2.0, "time": 0.0},
               "veh-x, 1.001, 2.001, 1.0",
               '{"vehicle_id": "veh-x", "latitude": 1.002, '
               '"longitude": 2.002, "ts": 2.0}',
               "garbage,,"]
        assert f.format_stream(raw, q) == 3
        assert f.stats() == {"normalized": 3, "dropped": 1}
        got = q.poll(partition_of("veh-x", 4), 0, 10)
        assert [r["time"] for _, r in got] == [0.0, 1.0, 2.0]

    def test_columns_equal_the_jax_formatter(self):
        from reporter_tpu.streaming.formatter import (
            ProbeFormatter as JProbeFormatter)

        raw = ["v1,1.0,2.0,3.0,4.0", {"vehicle_id": "v2", "lat": 1.5,
                                      "lng": 2.5}, "junk", b"v3,1,2,"]
        a = ProbeFormatter().normalize_columns(raw)
        b = JProbeFormatter().normalize_columns(raw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype

    def test_feeds_stream_pipeline(self, stream_tiles):
        pipe = StreamPipeline(stream_tiles, Config(), device="cpu")
        f = ProbeFormatter()
        fleet = ptraces.synthesize_fleet(stream_tiles, 3, num_points=40, seed=6)
        raw = []
        for i, p in enumerate(fleet):
            for (lo, la), t in zip(p.lonlat, p.times):
                if i == 0:
                    raw.append({"uuid": p.uuid, "lat": la, "lon": lo,
                                "time": t})
                elif i == 1:
                    raw.append(f"{p.uuid},{la},{lo},{t}")
                else:
                    raw.append({"vehicle_id": p.uuid, "latitude": la,
                                "longitude": lo, "timestamp": t})
        assert f.format_stream(raw, pipe.queue) == len(raw)
        pipe.step(force_flush=True)
        assert pipe.stats()["lag"] == 0 and pipe.stats()["malformed"] == 0


# ---------------------------------------------------------------------------
# The native streaming functions


def _random_record_columns(rng, n, cls):
    """Walker-shaped columns: adjacency chains, partial (-1) and NaN
    times, internal connectors."""
    trace = np.sort(rng.integers(0, 6, n)).astype(np.int32)
    t0 = rng.uniform(-1, 5, n)
    t1 = t0 + rng.uniform(-0.5, 2, n)
    for i in range(1, n):
        if rng.random() < 0.5 and trace[i] == trace[i - 1]:
            t0[i] = t1[i - 1] + rng.choice([0.0, 5e-4, 2e-3])
        if rng.random() < 0.2:
            t0[i] = -1.0
        if rng.random() < 0.2:
            t1[i] = -1.0
        if rng.random() < 0.05:
            t0[i] = np.nan
        if rng.random() < 0.05:
            t1[i] = np.nan
    return cls(trace, rng.integers(0, 1000, n).astype(np.int64), t0, t1,
               rng.uniform(0, 50, n), rng.uniform(0, 20, n),
               rng.random(n) < 0.3, np.zeros(n + 1, np.int64),
               np.empty(0, np.int64))


def _assert_same(a, b):
    for x, y in zip(a[:6], b[:6]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    if a[6] is None:
        assert b[6] is None
    else:
        np.testing.assert_array_equal(a[6], b[6])


@pytest.mark.parametrize("n_traces", [None, 6])
def test_build_reports_fuzz(n_traces):
    """The C build equals its numpy form and the JAX package's native
    form, NaN times included (they fail the >= 0 gates alike)."""
    rng = np.random.default_rng(17)
    for _ in range(150):
        n = int(rng.integers(0, 60))
        state = rng.bit_generator.state
        cols = _random_record_columns(rng, n, RecordColumns)
        rng2 = np.random.default_rng()
        rng2.bit_generator.state = state
        jcols = _random_record_columns(rng2, n, JRecordColumns)
        with np.errstate(invalid="ignore"):
            plain = build_report_columns(cols, n_traces, 10.0)
        native = npp.build_reports(cols, n_traces, 10.0)
        jnative = jnp_prepare.build_reports(jcols, n_traces, 10.0)
        _assert_same(plain, native)
        _assert_same(jnative, native)


def test_tail_cuts_fuzz():
    rng = np.random.default_rng(23)
    for trial in range(300):
        V = int(rng.integers(1, 9))
        bounds = np.zeros(V + 1, np.int64)
        bounds[1:] = np.cumsum(rng.integers(0, 30, V))
        t = np.sort(rng.uniform(0, 100, int(bounds[-1])))
        from_time = rng.uniform(-10, 120, V)
        if trial % 2:                  # ties: whole seconds on both sides
            t = np.floor(t)
            from_time = np.floor(from_time)
        max_points = int(rng.integers(1, 40))
        plain = npp.tail_cuts_python(t, bounds, from_time, max_points)
        native = npp.tail_cuts(t, bounds, from_time, max_points)
        jnative = jnp_prepare.tail_cuts(t, bounds, from_time, max_points)
        np.testing.assert_array_equal(plain, native)
        np.testing.assert_array_equal(jnative, native)
        # a NaN from_time matches no time, as numpy's comparison (the JAX
        # package's C lower bound would stop at the first)
        from_time[0] = np.nan
        with np.errstate(invalid="ignore"):
            plain = npp.tail_cuts_python(t, bounds, from_time, max_points)
        np.testing.assert_array_equal(
            plain, npp.tail_cuts(t, bounds, from_time, max_points))
