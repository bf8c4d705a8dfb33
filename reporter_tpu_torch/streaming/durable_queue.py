"""DurableIngestQueue: the file-backed probe log (Kafka's durability role).

Counterpart: reporter_tpu/streaming/durable_queue.py, with the same
files, so either package opens a broker directory the other wrote. The
recovery model is "replay from committed offsets: the buffer is derived
state, the log is the truth". The in-process IngestQueue dies with the
process; this subclass persists the same offset-addressed log, so a
restarted worker constructs its pipeline over the same directory and
replays the unflushed tail. All offset and retention semantics live in
IngestQueue; this class only adds the persistence hooks.

Layout under ``dir/``: ``meta.json`` (``{"num_partitions", "format":
"records"}``) and one append-only JSON-lines file per partition
(``p0.log`` ...). After a retention rewrite the first line is a header
``{"_floor": N}`` recording the partition's base offset, inside the log,
so content and floor change in one atomic ``os.replace``.

Durability: appends are flushed to the OS on every call (safe against
process death); ``fsync=True`` also fsyncs per append (power loss). A
torn final line (killed mid-write) is dropped on reload and truncated
from the file before the append handle reopens, so the next acked record
cannot concatenate onto the fragment.
"""

from __future__ import annotations

import json
import os

from reporter_tpu_torch.streaming.queue import IngestQueue


def _encode(record: dict) -> bytes:
    return json.dumps(record, separators=(",", ":")).encode() + b"\n"


def read_broker_format(dir: str) -> "str | None":
    """The format a broker directory was created with ('records' |
    'columnar'), or None for a fresh/absent directory. The one meta.json
    defaulting rule — shared by both durable queue classes and the
    worker CLI's broker sniff."""
    meta_path = os.path.join(dir, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f).get("format", "records")


def open_or_create_meta(dir: str, fmt: str, num_partitions: int,
                        other_class: str) -> None:
    """Pin (or validate) a broker directory's identity: partition count
    and log format. The pin is written once, fsync'd (file AND
    directory) — losing it to a power cut while fsync'd records survive
    would let a mis-configured reopen recreate it wrong; a mismatched
    reopen is refused, never reinterpreted."""
    os.makedirs(dir, exist_ok=True)
    meta_path = os.path.join(dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        stored_fmt = meta.get("format", "records")
        if stored_fmt != fmt:
            raise ValueError(
                f"{dir}: broker log format is {stored_fmt!r}, not "
                f"{fmt!r} — directories are format-specific; use "
                f"{other_class} or a fresh directory")
        stored = int(meta["num_partitions"])
        if stored != num_partitions:
            raise ValueError(
                f"{dir}: log was created with num_partitions={stored}, "
                f"reopened with {num_partitions} — records would "
                "be orphaned/mis-routed; migrate explicitly instead")
        return
    with open(meta_path + ".tmp", "w") as f:
        json.dump({"num_partitions": num_partitions, "format": fmt}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(meta_path + ".tmp", meta_path)
    dfd = os.open(dir, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class DurableIngestQueue(IngestQueue):
    """IngestQueue whose log survives the process."""

    def __init__(self, dir: str, num_partitions: int = 4,
                 fsync: bool = False,
                 max_records_per_partition: "int | None" = None,
                 overload_policy: str = "reject"):
        super().__init__(num_partitions, max_records_per_partition,
                         overload_policy)
        self.dir = dir
        self._fsync = bool(fsync)
        # The partition count and format are the log's identity: a
        # mismatched reopen is refused (open_or_create_meta), never
        # reinterpreted.
        open_or_create_meta(dir, "records", self.num_partitions,
                            other_class="DurableColumnarIngestQueue")
        self._files = []
        for p in range(self.num_partitions):
            base, records, good_bytes = self._load_partition(p)
            self._base[p] = base
            self._parts[p] = records
            path = self._log_path(p)
            if os.path.exists(path) and os.path.getsize(path) > good_bytes:
                # torn/corrupt tail: cut it from the FILE too, or the next
                # acked append merges into the fragment and poisons the
                # line after it on the following reload
                with open(path, "rb+") as f:
                    f.truncate(good_bytes)
            self._files.append(open(path, "ab"))

    # ---- persistence ----------------------------------------------------

    def _log_path(self, p: int) -> str:
        return os.path.join(self.dir, f"p{p}.log")

    def _load_partition(self, p: int) -> "tuple[int, list, int]":
        """(base offset, records, byte length of the valid prefix)."""
        base, records, good = 0, [], 0
        path = self._log_path(p)
        if not os.path.exists(path):
            return base, records, good
        with open(path, "rb") as f:
            first = True
            for line in f:
                if not line.endswith(b"\n"):
                    break               # torn tail from a mid-write crash
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    break               # corrupt tail: stop at last good
                if first and isinstance(obj, dict) and set(obj) == {"_floor"}:
                    base = int(obj["_floor"])
                else:
                    records.append(obj)
                first = False
                good += len(line)
        return base, records, good

    def close(self) -> None:
        with self._lock:
            for f in self._files:
                f.close()
            self._files = []

    # ---- IngestQueue durability hooks (run under the lock) ---------------

    def _persist(self, p: int, record: dict) -> None:
        f = self._files[p]
        f.write(_encode(record))
        f.flush()
        if self._fsync:
            os.fsync(f.fileno())

    def _persist_truncate(self, p: int) -> None:
        """Rewrite the partition log as header + surviving records, in one
        atomic rename — base and content can never desync."""
        self._files[p].close()
        tmp = self._log_path(p) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_encode({"_floor": self._base[p]}))
            for r in self._parts[p]:
                f.write(_encode(r))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._log_path(p))
        if self._fsync:
            # Power-loss safety requires the RENAME to be durable too, or
            # later fsync'd appends land on an inode the replayed journal
            # may not point at; process-death safety doesn't need this.
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        self._files[p] = open(self._log_path(p), "ab")
