"""The one JSONL event log: topology events, lease audits, alert ledgers.

Counterpart: reporter_tpu/utils/eventlog.py (``read_events``,
``EventLog``), byte-for-byte the same files for the same appends. Every
append is ONE ``write()`` of complete lines followed by ``flush()``, so a
reader never sees a half-written prefix of the log, only possibly a torn
final line after a crash; reopening an existing log truncates a torn
tail, so a restarted appender never extends a half-written line into a
corrupt one. No fsync: durability to the disk is the snapshot spool's
job (``distributed/aggregate.py``), and crash exposure is one tail line,
which the truncation at reopen and the tolerant reader both handle. One
named lock class (``eventlog.append``) is shared by every instance.
"""

from __future__ import annotations

import json
import os

from reporter_tpu_torch.utils.locks import named_lock


def _truncate_torn_tail(path: str) -> None:
    """Cut a trailing partial line (crash mid-append) back to the last
    complete one.  Event logs are small — whole-file read keeps this
    obviously correct."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "rb+") as fh:
        fh.seek(-1, os.SEEK_END)
        if fh.read(1) == b"\n":
            return
        fh.seek(0)
        data = fh.read()
        cut = data.rfind(b"\n")
        fh.truncate(cut + 1 if cut >= 0 else 0)


def read_events(path):
    """Tolerant JSONL reader: parse complete lines, stop at the first
    unparsable one (with atomic appends the only malformed line is a
    torn tail written by a process that crashed since the last
    reopen)."""
    out = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break
    except FileNotFoundError:
        pass
    return out


class EventLog:
    """Append-only JSONL log with torn-tail truncation at reopen."""

    def __init__(self, path: str):
        self.path = path
        self._lock = named_lock("eventlog.append")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        _truncate_torn_tail(path)

    def append(self, doc: dict) -> None:
        self.extend((doc,))

    def extend(self, docs) -> None:
        lines = "".join(json.dumps(d) + "\n" for d in docs)
        if not lines:
            return
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(lines)
                fh.flush()

    def read(self):
        return read_events(self.path)
