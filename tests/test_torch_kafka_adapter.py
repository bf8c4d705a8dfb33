"""The port's Kafka consumer adapter (reporter_tpu_torch/streaming/
kafka_adapter.py) against the JAX package's, on the CPU.

The adapter runs the JAX package's ProbeConsumer contract suite
(tests/test_broker_contract.py ``check_probe_consumer``) and the port's
(tests/test_torch_streaming.py), over the fake kafka-python client of
tests/test_kafka_adapter.py: no network, no ``kafka`` package. Then
parity, tolerance 0: the same record stream, built with numpy from a
seed, produced into two fake clients, one consumed by the JAX
``StreamPipeline`` over the JAX adapter (dense candidates), the other by
the port's ``StreamPipeline(..., device="cpu")`` over the port's
adapter; the published bodies, both histograms and the committed offsets
must be equal, and equal to the port's pipeline over its in-memory
queue. The port's columnar pipeline over the adapter publishes the same
reports.
"""

import json

import numpy as np
import pytest

from reporter_tpu.config import Config as JConfig
from reporter_tpu.config import MatcherParams as JMatcherParams
from reporter_tpu.config import ServiceConfig as JServiceConfig
from reporter_tpu.config import StreamingConfig as JStreamingConfig
from reporter_tpu.streaming import StreamPipeline as JStreamPipeline
from reporter_tpu.streaming.kafka_adapter import (
    KafkaProbeConsumer as JKafkaProbeConsumer)
from reporter_tpu.streaming.kafka_adapter import (
    TopicPartition as JTopicPartition)
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import Config, ServiceConfig, StreamingConfig
from reporter_tpu_torch.streaming import (ColumnarStreamPipeline,
                                          IngestQueue, KafkaProbeConsumer,
                                          ProbeConsumer, StreamPipeline,
                                          TopicPartition)
from reporter_tpu_torch.streaming.queue import partition_of
from tests.test_broker_contract import check_probe_consumer as jax_contract
from tests.test_kafka_adapter import FakeKafkaClient
from tests.test_torch_streaming import (URL, FakeClock, _capture, _stream,
                                        jtiles, stream_tiles)  # noqa: F401
from tests.test_torch_streaming import check_probe_consumer as port_contract

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.mark.parametrize("parts", [4, 1])
def test_contract_of_both_packages(parts):
    client = FakeKafkaClient("probes", num_partitions=parts)
    adapter = KafkaProbeConsumer(client, "probes")
    assert isinstance(adapter, ProbeConsumer)
    jax_contract(adapter, client.produce)
    port_contract(adapter, client.produce)


def test_small_fetch_batches_are_drained():
    """One pipeline poll may take several client fetches (Kafka's
    max_poll_records caps a fetch, not a request)."""
    client = FakeKafkaClient("probes", num_partitions=1, fetch_batch=3)
    adapter = KafkaProbeConsumer(client, "probes")
    jadapter = JKafkaProbeConsumer(client, "probes")
    for i in range(20):
        client.produce({"uuid": "v", "lat": 0.0, "lon": 0.0,
                        "time": float(i)})
    got = adapter.poll(0, 0, max_records=17)
    assert [off for off, _ in got] == list(range(17))
    assert got == jadapter.poll(0, 0, max_records=17)
    assert adapter.poll(0, 5, 100) == jadapter.poll(0, 5, 100)


def test_retention_floor_maps_to_lookup_error():
    client = FakeKafkaClient("probes", num_partitions=2)
    adapter = KafkaProbeConsumer(client, "probes")
    for i in range(10):
        client.produce({"uuid": "v", "lat": 0.0, "lon": 0.0,
                        "time": float(i)})
    p = partition_of("v", 2)
    tp = TopicPartition("probes", p)
    client.expire(p, client.end_offsets([tp])[tp])
    with pytest.raises(LookupError, match="retention floor"):
        adapter.poll(p, 0, max_records=4)
    other = KafkaProbeConsumer(client, "probes")
    client.floor[p] = 0
    assert other.poll(p, 0, 4) == JKafkaProbeConsumer(
        client, "probes").poll(p, 0, 4)


def test_topic_partition_is_the_jax_twin():
    tp, jtp = TopicPartition("probes", 3), JTopicPartition("probes", 3)
    assert tp == jtp and hash(tp) == hash(jtp)
    assert {jtp: 1}[tp] == 1


@pytest.mark.parametrize("topic,parts,match", [
    ("other-topic", 2, "no partitions"),
    ("probes", None, "not dense")], ids=["missing", "sparse"])
def test_bad_topics_rejected_like_the_jax_adapter(topic, parts, match):
    client = FakeKafkaClient("probes", num_partitions=2)
    if parts is None:
        client.partitions_for_topic = lambda t: {0, 2}
    errors = []
    for cls in (KafkaProbeConsumer, JKafkaProbeConsumer):
        with pytest.raises(ValueError, match=match) as ei:
            cls(client, topic)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def test_predeserialized_values_pass_through():
    """A client built with value_deserializer=json.loads hands dicts;
    both forms decode alike, as in the JAX adapter."""
    rec = {"uuid": "v", "lat": 1.0, "lon": 2.0, "time": 3.0}
    for raw in (json.dumps(rec).encode(), bytearray(json.dumps(rec).encode()),
                json.dumps(rec), rec):
        assert KafkaProbeConsumer._decode(raw) == \
            JKafkaProbeConsumer._decode(raw) == rec


def _feed(pipe, client, clock, recs, rounds):
    for chunk in np.array_split(np.arange(len(recs)), rounds):
        for i in chunk:
            client.produce(recs[i])
        pipe.step()
        clock.now += 2.0
    pipe.drain()


@pytest.mark.parametrize("seed,rounds", [(3, 6), (11, 4)])
def test_pipeline_over_the_adapter_equals_the_jax_pipeline(
        jtiles, stream_tiles, seed, rounds):  # noqa: F811
    recs = _stream(jtiles, seed)
    kw = dict(flush_min_points=12, flush_max_age=5.0,
              poll_max_records=64, hist_flush_interval=5.0)
    jclient = FakeKafkaClient("probes", num_partitions=4)
    pclient = FakeKafkaClient("probes", num_partitions=4)
    jpub, ppub, qpub = [], [], []
    jclock, pclock, qclock = FakeClock(), FakeClock(), FakeClock()
    jp = JStreamPipeline(jtiles, JConfig(
        matcher=JMatcherParams(candidate_backend="dense"),
        service=JServiceConfig(datastore_url=URL),
        streaming=JStreamingConfig(**kw)),
        queue=JKafkaProbeConsumer(jclient, "probes"),
        transport=_capture(jpub), clock=jclock)
    cfg = Config(service=ServiceConfig(datastore_url=URL),
                 streaming=StreamingConfig(**kw))
    pp = StreamPipeline(stream_tiles, cfg,
                        queue=KafkaProbeConsumer(pclient, "probes"),
                        transport=_capture(ppub), clock=pclock, device="cpu")
    qp = StreamPipeline(stream_tiles, cfg, queue=IngestQueue(4),
                        transport=_capture(qpub), clock=qclock, device="cpu")
    _feed(jp, jclient, jclock, recs, rounds)
    _feed(pp, pclient, pclock, recs, rounds)

    class _Appender:                 # the in-memory queue as a producer
        def produce(self, r):
            qp.queue.append(r)

    _feed(qp, _Appender(), qclock, recs, rounds)
    for pipe in (jp, pp, qp):
        pipe.flush_histograms()
    assert ppub == jpub == qpub
    assert any(b.get("reports") for b in ppub)
    np.testing.assert_array_equal(pp.hist.snapshot(), jp.hist.snapshot())
    np.testing.assert_array_equal(pp.qhist.snapshot(), jp.qhist.snapshot())
    assert pp.committed == jp.committed == qp.committed
    assert pp.malformed == jp.malformed == 3
    assert pp.stats()["lag"] == 0


def test_columnar_pipeline_over_the_adapter(jtiles, stream_tiles):  # noqa: F811
    """The columnar pipeline (depth 0) polls the adapter through its
    per-record shim and publishes the reports its in-memory run does."""
    recs = [r for r in _stream(jtiles, 5) if r["uuid"] != "poison"]
    kw = dict(flush_min_points=12, flush_max_age=1e9,
              poll_max_records=10_000, hist_flush_interval=0.0,
              pipeline_depth=0)
    cfg = Config(service=ServiceConfig(datastore_url=URL),
                 streaming=StreamingConfig(**kw))
    out = []
    for use_kafka in (True, False):
        pub = []
        client = FakeKafkaClient("probes", num_partitions=4)
        queue = (KafkaProbeConsumer(client, "probes") if use_kafka
                 else IngestQueue(4))
        pipe = ColumnarStreamPipeline(stream_tiles, cfg, queue=queue,
                                      transport=_capture(pub),
                                      clock=FakeClock(), device="cpu")
        for chunk in np.array_split(np.arange(len(recs)), 3):
            for i in chunk:
                (client.produce if use_kafka else queue.append)(recs[i])
            pipe.step()
        pipe.drain()
        pipe.close()
        assert pipe.stats()["lag"] == 0
        out.append(sorted(json.dumps(r, sort_keys=True)
                          for b in pub for r in b.get("reports", ())))
    assert out[0] == out[1] and out[0]
