"""IngestQueue: partitioned, offset-addressed probe log.

Counterpart: reporter_tpu/streaming/queue.py. Records are appended to
uuid-hash partitions, consumers poll (partition, offset) ranges, and
nothing is destroyed by consumption: replay from any retained offset is
the recovery mechanism. ``partition_of`` is the JAX package's crc32, so
a uuid lands in the same partition in both packages.
"""

from __future__ import annotations

import zlib
from typing import Any, Sequence

from reporter_tpu_torch.utils import locks


def partition_of(uuid: str, num_partitions: int) -> int:
    """Stable uuid→partition hash (crc32 — processes must agree, so no
    Python string-hash randomization)."""
    return zlib.crc32(uuid.encode()) % num_partitions


class IngestQueue:
    """Thread-safe partitioned append log with offset-based polling.

    ``max_records_per_partition`` bounds the retained backlog with the
    same counted overload policies as the columnar broker ("reject":
    producer-side refusal, ``append`` returns (partition, -1) and counts
    ``rejected``; "drop_oldest": the retention floor advances past aged
    records, counted in ``dropped_oldest``) — see
    ColumnarIngestQueue's docstring for the policy contract."""

    def __init__(self, num_partitions: int = 4,
                 max_records_per_partition: "int | None" = None,
                 overload_policy: str = "reject"):
        self.num_partitions = int(num_partitions)
        if overload_policy not in ("reject", "drop_oldest"):
            raise ValueError(f"unknown overload_policy {overload_policy!r};"
                             " use 'reject' or 'drop_oldest'")
        self.max_records_per_partition = (
            None if max_records_per_partition is None
            else int(max_records_per_partition))
        self.overload_policy = overload_policy
        self.rejected = 0
        self.dropped_oldest = 0
        self._parts: list[list[Any]] = [[] for _ in range(self.num_partitions)]
        self._base: list[int] = [0] * self.num_partitions   # offset of _parts[p][0]
        self._lock = locks.named_lock("broker.partitions")

    def append(self, record: dict) -> tuple[int, int]:
        """Producer API: route by record["uuid"], return (partition,
        offset); (partition, -1) when a "reject"-policy bound refused it."""
        p = partition_of(str(record.get("uuid", "")), self.num_partitions)
        bound = self.max_records_per_partition
        with self._lock:
            if bound is not None and len(self._parts[p]) >= bound:
                if self.overload_policy == "reject":
                    self.rejected += 1
                    return p, -1
                # shed a CHUNK, not one record: a per-record shed at the
                # bound costs an O(bound) list copy — and for the durable
                # subclass a full partition-file rewrite + fsync — per
                # appended probe, exactly when the broker is overloaded.
                # Chunking amortizes that to ~8 rewrites per bound-fill.
                drop = max(1, bound // 8, len(self._parts[p]) - bound + 1)
                drop = min(drop, len(self._parts[p]))
                self._parts[p] = self._parts[p][drop:]
                self._base[p] += drop
                self.dropped_oldest += drop
                self._persist_truncate(p)
            self._persist(p, record)
            self._parts[p].append(record)
            return p, self._base[p] + len(self._parts[p]) - 1

    def retention_floor(self, partition: int) -> int:
        """Oldest pollable offset (consumers skip here after an overrun
        LookupError)."""
        with self._lock:
            return self._base[partition]

    def overload_stats(self) -> dict:
        """Counted shedding outcomes for /stats surfaces."""
        with self._lock:
            return {"broker_policy": self.overload_policy,
                    "broker_bound": self.max_records_per_partition,
                    "broker_rejected": int(self.rejected),
                    "broker_dropped_oldest": int(self.dropped_oldest)}

    def _persist(self, p: int, record: dict) -> None:
        """Durability hook (DurableIngestQueue): runs under the lock BEFORE
        the in-memory append, so on-disk line order always matches offset
        order even with concurrent producers. No-op in-proc."""

    def append_many(self, records: Sequence[dict]) -> None:
        for r in records:
            self.append(r)

    def poll(self, partition: int, offset: int,
             max_records: int) -> list[tuple[int, dict]]:
        """Records at or after ``offset`` (as [(offset, record)…])."""
        with self._lock:
            base = self._base[partition]
            if offset < base:
                raise LookupError(
                    f"offset {offset} below retention floor {base} "
                    f"(partition {partition})")
            lo = offset - base
            chunk = self._parts[partition][lo:lo + max_records]
            return [(offset + i, r) for i, r in enumerate(chunk)]

    def end_offset(self, partition: int) -> int:
        with self._lock:
            return self._base[partition] + len(self._parts[partition])

    def lag(self, committed: Sequence[int]) -> int:
        """Total records past the given per-partition committed offsets."""
        return sum(self.end_offset(p) - committed[p]
                   for p in range(self.num_partitions))

    def truncate(self, committed: Sequence[int]) -> None:
        """Drop records below the committed offsets (retention)."""
        with self._lock:
            for p, off in enumerate(committed):
                drop = max(0, off - self._base[p])
                if drop:
                    self._parts[p] = self._parts[p][drop:]
                    self._base[p] += drop
                    self._persist_truncate(p)

    def _persist_truncate(self, p: int) -> None:
        """Durability hook: rewrite partition p's backing store to match
        the truncated in-memory state. Runs under the lock. No-op in-proc."""
