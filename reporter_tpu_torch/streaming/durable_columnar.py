"""DurableColumnarIngestQueue: the file-backed columnar probe log.

Counterpart: reporter_tpu/streaming/durable_columnar.py, with the same
frames and ``meta.json``, so either package opens a directory the other
wrote. The columnar twin of DurableIngestQueue (same recovery model,
same crash discipline), storing batches instead of JSON lines. Layout
under ``dir/``: one append-only file per partition (``p0.colog`` ...) of
length-prefixed frames (8-byte big-endian length); frame 0 is a JSON
header ``{"_floor": N}`` and every later frame one npz-compressed
ProbeColumns sub-batch (uuid as a unicode array, never pickled).
Retention rewrites the file (header + surviving batches) through one
atomic ``os.replace``. A torn final frame is dropped on reload and
truncated from the file before the append handle reopens. The ``broker``
fault site tears (``torn``) or kills (``crash``, ``fail``) an append.

Broker directories are format-specific: ``meta.json`` pins the partition
count and ``format: columnar``, and a reopen with the record broker
class (or the other way) is refused.
"""

from __future__ import annotations

import io
import json
import os
import struct

import numpy as np

from reporter_tpu_torch.streaming.columnar import ColumnarIngestQueue, ProbeColumns
from reporter_tpu_torch.streaming.durable_queue import open_or_create_meta

_LEN = struct.Struct(">Q")


def _encode_batch(cols: ProbeColumns) -> bytes:
    buf = io.BytesIO()
    # Normalize dtypes at the WRITE side: an object-dtype uuid column
    # (legal from a direct columnar producer) would savez as a pickle,
    # which the pickle-refusing decode below then treats as a torn tail —
    # silently truncating acked data on reload.
    np.savez_compressed(
        buf, uuid=np.asarray(cols.uuid, np.str_),
        lat=np.asarray(cols.lat, np.float64),
        lon=np.asarray(cols.lon, np.float64),
        time=np.asarray(cols.time, np.float64),
        accuracy=np.asarray(cols.accuracy, np.float32))
    blob = buf.getvalue()
    return _LEN.pack(len(blob)) + blob


def _decode_batch(blob: bytes) -> ProbeColumns:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return ProbeColumns(z["uuid"], z["lat"], z["lon"], z["time"],
                            z["accuracy"])


class DurableColumnarIngestQueue(ColumnarIngestQueue):
    """ColumnarIngestQueue whose batch log survives the process."""

    def __init__(self, dir: str, num_partitions: int = 4,
                 fsync: bool = False,
                 max_records_per_partition: "int | None" = None,
                 overload_policy: str = "reject"):
        super().__init__(num_partitions, max_records_per_partition,
                         overload_policy)
        self.dir = dir
        self._fsync = bool(fsync)
        open_or_create_meta(dir, "columnar", self.num_partitions,
                            other_class="DurableIngestQueue")
        self._files = []
        for p in range(self.num_partitions):
            good = self._load_partition(p)
            path = self._log_path(p)
            if os.path.exists(path) and os.path.getsize(path) > good:
                with open(path, "rb+") as f:
                    f.truncate(good)      # cut the torn tail from the FILE
            self._files.append(open(path, "ab"))

    # ---- persistence ----------------------------------------------------

    def _log_path(self, p: int) -> str:
        return os.path.join(self.dir, f"p{p}.colog")

    def _load_partition(self, p: int) -> int:
        """Rebuild partition p in memory; returns the byte length of the
        valid frame prefix."""
        path = self._log_path(p)
        if not os.path.exists(path):
            return 0
        good = 0
        first = True
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i + _LEN.size <= len(data):
            (n,) = _LEN.unpack_from(data, i)
            if i + _LEN.size + n > len(data):
                break                     # torn tail from a mid-write crash
            blob = data[i + _LEN.size:i + _LEN.size + n]
            try:
                if first:
                    hdr = json.loads(blob)
                    self._floor[p] = int(hdr["_floor"])
                    self._end[p] = int(hdr["_floor"])
                else:
                    cols = _decode_batch(blob)
                    self._bases[p].append(self._end[p])
                    self._batches[p].append(cols)
                    self._end[p] += cols.n
            except Exception:
                break                     # corrupt tail: stop at last good
            first = False
            i += _LEN.size + n
            good = i
        if first:
            return 0                      # empty/unreadable: fresh file
        return good

    def close(self) -> None:
        with self._lock:
            for f in self._files:
                f.close()
            self._files = []

    # ---- ColumnarIngestQueue durability hooks (run under the lock) ------

    def _persist_batch(self, p: int, cols: ProbeColumns) -> None:
        from reporter_tpu_torch import faults

        f = self._files[p]
        if f.tell() == 0:                 # fresh file: header frame first
            hdr = json.dumps({"_floor": self._floor[p]}).encode()
            f.write(_LEN.pack(len(hdr)) + hdr)
        frame = _encode_batch(cols)
        rule = faults.check("broker")
        if rule is not None and rule.kind == "torn":
            # injected mid-append death: half a frame reaches disk, then
            # the "process" dies — the torn-tail reload path must drop
            # exactly this frame and keep every acked one before it
            f.write(frame[:len(frame) // 2])
            f.flush()
            raise faults.InjectedCrash(
                f"injected torn append (partition {p})")
        if rule is not None and rule.kind in ("crash", "fail"):
            raise faults.InjectedCrash(
                f"injected broker append crash (partition {p})")
        f.write(frame)
        f.flush()
        if self._fsync:
            os.fsync(f.fileno())

    def _persist_truncate(self, p: int) -> None:
        """Rewrite the partition log as header + surviving batches in one
        atomic rename — floor and content can never desync."""
        self._files[p].close()
        tmp = self._log_path(p) + ".tmp"
        with open(tmp, "wb") as f:
            hdr = json.dumps({"_floor": self._floor[p]}).encode()
            f.write(_LEN.pack(len(hdr)) + hdr)
            for cols in self._batches[p]:
                f.write(_encode_batch(cols))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._log_path(p))
        if self._fsync:
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        self._files[p] = open(self._log_path(p), "ab")
