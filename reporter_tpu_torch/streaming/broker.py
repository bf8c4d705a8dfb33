"""ProbeConsumer: the broker-consumer protocol the stream pipelines poll.

Counterpart: reporter_tpu/streaming/broker.py. The reference consumes
probe records from Kafka; here the in-process ``IngestQueue`` (and the
durable and columnar brokers) stand in. Everything the matcher worker
needs from a broker is offset-addressed polling over a fixed partition
count, so an external adapter plugs into ``StreamPipeline(queue=...)``
by implementing three members:

  =================  ================================================
  protocol member    Kafka equivalent
  =================  ================================================
  num_partitions     partition count of the subscribed topic
  poll(p, off, n)    seek(TopicPartition(p), off) + poll(max_records=n)
  end_offset(p)      end_offsets([TopicPartition(p)])
  =================  ================================================

Offset semantics the pipelines rely on (tests/test_torch_streaming.py
holds every broker of this package to them):

- Offsets are per-partition, dense and stable: the record first seen at
  (p, off) is returned for every later poll covering off (replay is the
  recovery mechanism: at-least-once delivery).
- ``poll`` returns records in offset order, at most ``max_records``,
  starting at exactly ``offset``; an empty list past the end.
- ``end_offset`` is one past the last record, so ``end_offset -
  committed`` is the lag.
- Polling below the retention floor raises ``LookupError``. If the
  broker also offers ``retention_floor(p)``, the pipelines treat the
  raise as an overload shed (drop-oldest policy): they skip to the floor
  and count the gap in their ``overrun`` stat. Without that accessor the
  raise stays unrecoverable data loss.

Bounded brokers (optional): the in-process queues accept
``max_records_per_partition`` + ``overload_policy`` ("reject" =
producer-side refusal, counted in ``rejected``; "drop_oldest" = the
floor advances past aged records, counted in ``dropped_oldest``) and
expose ``overload_stats()``, which the pipelines merge into their stats.

Commit state lives in the pipeline (its commit floor is the oldest
unflushed record, a property of the matcher's buffers, not of the
broker).

Trace metadata (optional): a producer may stamp a record with
``tracing.stamp_record(record, trace_id)``; record brokers store dicts
verbatim, so the key rides the log, and StreamPipeline tags its spans
with the inherited id. The columnar broker stores five fixed columns and
does not carry it.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class ProbeConsumer(Protocol):
    """What StreamPipeline polls (see module docstring for semantics)."""

    num_partitions: int

    def poll(self, partition: int, offset: int,
             max_records: int) -> "list[tuple[int, dict]]":
        """Records at/after ``offset`` as [(offset, record)...], in offset
        order, at most ``max_records``; raises LookupError below the
        retention floor."""
        ...

    def end_offset(self, partition: int) -> int:
        """One past the last record of the partition."""
        ...
