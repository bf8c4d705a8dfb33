"""Streaming ingest on the port's matcher.

Counterpart: reporter_tpu/streaming/. Probe producer, broker
(partitioned by uuid), matcher worker, datastore: the broker is a
partitioned log with replayable offsets behind the ProbeConsumer
protocol (broker.py), in memory (queue.IngestQueue, columnar.
ColumnarIngestQueue), on disk (durable_queue.DurableIngestQueue,
durable_columnar.DurableColumnarIngestQueue), in the JAX package's file
formats, or a Kafka topic through an injected client
(kafka_adapter.KafkaProbeConsumer); the matcher worker is StreamPipeline
or ColumnarStreamPipeline, which buffer per uuid, flush ripe buffers
through the batched matcher on the card, accumulate per-segment speed
histograms in device memory, and checkpoint offsets, cache tails and
histograms in the JAX package's npz schema. ``python -m reporter_tpu_torch.streaming`` runs one worker.
"""

from reporter_tpu_torch.streaming.broker import ProbeConsumer
from reporter_tpu_torch.streaming.columnar import (
    ColumnarIngestQueue,
    ColumnarStreamPipeline,
    ColumnarTraceCache,
    ProbeColumns,
    pack_records,
)
from reporter_tpu_torch.streaming.formatter import ProbeFormatter
from reporter_tpu_torch.streaming.queue import IngestQueue
from reporter_tpu_torch.streaming.durable_queue import DurableIngestQueue
from reporter_tpu_torch.streaming.durable_columnar import (
    DurableColumnarIngestQueue,
)
from reporter_tpu_torch.streaming.histogram import SpeedHistogram
from reporter_tpu_torch.streaming.kafka_adapter import (KafkaProbeConsumer,
                                                        TopicPartition)
from reporter_tpu_torch.streaming.pipeline import StreamPipeline
from reporter_tpu_torch.streaming.worker import StreamWorker

__all__ = ["ColumnarIngestQueue", "ColumnarStreamPipeline",
           "ColumnarTraceCache", "DurableColumnarIngestQueue",
           "DurableIngestQueue", "IngestQueue", "KafkaProbeConsumer",
           "ProbeColumns", "ProbeConsumer", "ProbeFormatter",
           "SpeedHistogram", "StreamPipeline", "StreamWorker",
           "TopicPartition", "pack_records"]
