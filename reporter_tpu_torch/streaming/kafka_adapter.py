"""KafkaProbeConsumer — a ProbeConsumer over a Kafka client.

Counterpart: reporter_tpu/streaming/kafka_adapter.py. The reference's
matcher workers consume probe records from Kafka; the port's pipelines
(StreamPipeline, ColumnarStreamPipeline: ``queue=``) depend only on the
ProbeConsumer protocol (streaming/broker.py). The adapter is written
against the kafka-python consumer's API, and the client is duck-typed
and injected: the ``kafka`` package is never imported here, and the
tests run the broker contract over a fake client. With the real
package:

    from kafka import KafkaConsumer
    client = KafkaConsumer(bootstrap_servers=..., enable_auto_commit=False,
                           auto_offset_reset="none", group_id=None)
    pipeline = StreamPipeline(ts, cfg,
                              queue=KafkaProbeConsumer(client, "probes"))

The client surface used (kafka-python names and semantics):
  partitions_for_topic(topic) → set[int]
  assign([TopicPartition...]); seek(tp, offset); pause(*tps); resume(*tps)
  poll(timeout_ms=..., max_records=...) → {tp: [records with
      .offset/.value]}
  end_offsets([tp]) → {tp: int}

Mapping to the ProbeConsumer contract:
  - poll(p, off, n): resume partition p, pause the rest, seek to ``off``,
    then drain client.poll until ``n`` records or a poll comes back
    empty. Kafka's fetch is cursor-based; the explicit seek makes it
    offset-addressed, as the pipelines' replay recovery requires.
  - end_offset(p): an end_offsets round trip.
  - OffsetOutOfRange (a poll below the broker's retention floor) →
    LookupError, the contract's data-loss signal. Configure the real
    client with auto_offset_reset="none": "earliest" or "latest" would
    skip records silently instead of showing the loss.

``TopicPartition`` here is a structural twin of kafka-python's (both are
(topic, partition) named tuples, equal and hashed as tuples, so either
type keys the other's dicts).
"""

from __future__ import annotations

import json
from typing import Any, NamedTuple


class TopicPartition(NamedTuple):
    topic: str
    partition: int


def _is_offset_out_of_range(exc: BaseException) -> bool:
    """kafka-python raises kafka.errors.OffsetOutOfRangeError; matched by
    name, so the package is never imported here."""
    return any(t.__name__ == "OffsetOutOfRangeError"
               for t in type(exc).__mro__)


class KafkaProbeConsumer:
    """ProbeConsumer over an injected kafka-python-shaped client."""

    def __init__(self, client: Any, topic: str, *,
                 poll_timeout_ms: int = 500):
        parts = client.partitions_for_topic(topic)
        if not parts:
            raise ValueError(f"topic {topic!r} has no partitions "
                             "(missing, or metadata not yet fetched)")
        self.num_partitions = max(parts) + 1
        if set(parts) != set(range(self.num_partitions)):
            raise ValueError(f"topic {topic!r} partitions {sorted(parts)} "
                             "are not dense 0..P-1")
        self._client = client
        self._topic = topic
        self._timeout_ms = int(poll_timeout_ms)
        self._tps = [TopicPartition(topic, p)
                     for p in range(self.num_partitions)]
        # manual assignment, not subscribe(): partition ownership is the
        # pipeline's concern (its consumer group hands partitions to
        # workers); the broker-side group protocol stays out of the loop
        client.assign(list(self._tps))

    # ---- ProbeConsumer -------------------------------------------------

    def poll(self, partition: int, offset: int,
             max_records: int) -> "list[tuple[int, dict]]":
        tp = self._tps[partition]
        others = [t for t in self._tps if t is not tp]
        try:
            if others:
                self._client.pause(*others)
            self._client.resume(tp)
            self._client.seek(tp, offset)
            out: list[tuple[int, dict]] = []
            while len(out) < max_records:
                batch = self._client.poll(
                    timeout_ms=self._timeout_ms,
                    max_records=max_records - len(out))
                recs = (batch or {}).get(tp, [])
                if not recs:
                    break               # caught up (or fetch timeout)
                for r in recs:
                    if r.offset < offset:   # a fetch from before the seek
                        continue
                    out.append((int(r.offset), self._decode(r.value)))
            return out
        except Exception as exc:
            if _is_offset_out_of_range(exc):
                raise LookupError(
                    f"partition {partition} offset {offset} is below the "
                    "broker retention floor (data loss)") from exc
            raise

    def end_offset(self, partition: int) -> int:
        tp = self._tps[partition]
        return int(self._client.end_offsets([tp])[tp])

    # ---- helpers -------------------------------------------------------

    @staticmethod
    def _decode(value: Any) -> dict:
        """bytes → JSON record; a dict passes through (a client built
        with value_deserializer=json.loads hands dicts already)."""
        if isinstance(value, dict):
            return value
        if isinstance(value, (bytes, bytearray)):
            value = value.decode("utf-8")
        return json.loads(value)
