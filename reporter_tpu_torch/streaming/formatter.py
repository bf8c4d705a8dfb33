"""Probe formatter: the raw-to-canonical normalization stage.

Counterpart: reporter_tpu/streaming/formatter.py. Vendors deliver probes
as CSV lines, differently keyed JSON or nested envelopes; only canonical
records (``{"uuid", "lat", "lon", "time"[, "accuracy"]}``) reach the
matcher. ``ProbeFormatter.normalize`` maps one raw payload to that
record, ``format_stream`` pumps raw payloads into a broker (records are
partitioned by uuid after normalization), and ``normalize_columns`` /
``format_stream_columns`` do the same into one ProbeColumns batch for
the columnar broker.

Formats are pluggable: built-ins cover canonical JSON dicts, flat CSV
lines and common vendor field aliases; ``register`` adds more. Malformed
payloads return None and are counted, so a poison message can never
wedge a partition.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable

# one raw payload → canonical record dict, or None when not this format
FormatFn = Callable[[Any], "dict | None"]

_ALIASES = {
    "uuid": ("uuid", "id", "vehicle_id", "device_id", "driver_id"),
    "lat": ("lat", "latitude", "y"),
    "lon": ("lon", "lng", "longitude", "x"),
    "time": ("time", "timestamp", "ts", "t", "recorded_at"),
    "accuracy": ("accuracy", "acc", "hdop_m", "horizontal_accuracy"),
}


def _finite(v) -> "float | None":
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def _from_mapping(obj: "dict[str, Any]") -> "dict | None":
    """Canonical + alias-keyed flat dicts, and one nested-envelope level
    ({"location": {"lat": .., "lon": ..}, ...})."""
    loc = obj.get("location")
    if isinstance(loc, dict):
        obj = {**obj, **loc}
    rec: dict = {}
    for field, names in _ALIASES.items():
        # first alias with a USABLE value wins — a present-but-invalid
        # alias (e.g. "lat": null beside "latitude": 37.75) must not
        # shadow a later valid one
        for n in names:
            if n not in obj:
                continue
            if field == "uuid":
                # None must fall through to the next alias, not become the
                # literal "None" (which would merge every null-uuid vehicle
                # into one phantom stream)
                if obj[n] is None:
                    continue
                u = str(obj[n]).strip()
                if u:
                    rec["uuid"] = u
                    break
            else:
                v = _finite(obj[n])
                if v is not None:
                    rec[field] = v
                    break
    if "uuid" not in rec or "lat" not in rec or "lon" not in rec:
        return None
    if "accuracy" in rec and rec["accuracy"] < 0:
        del rec["accuracy"]
    return rec


def _from_csv(line: str) -> "dict | None":
    """``uuid,lat,lon,time[,accuracy]`` — the flat vendor CSV shape."""
    parts = [p.strip() for p in line.split(",")]
    if len(parts) < 3 or not parts[0]:
        return None
    lat, lon = _finite(parts[1]), _finite(parts[2])
    if lat is None or lon is None:
        return None
    rec = {"uuid": parts[0], "lat": lat, "lon": lon}
    if len(parts) > 3:
        t = _finite(parts[3])
        if t is not None:       # unparseable time degrades to a timeless
            rec["time"] = t     # record (like the mapping path), the
                                # pipeline assigns index seconds
    if len(parts) > 4:
        acc = _finite(parts[4])
        if acc is not None and acc >= 0:
            rec["accuracy"] = acc
    return rec


def _default_formats() -> "dict[str, FormatFn]":
    def auto(payload):
        if isinstance(payload, dict):
            return _from_mapping(payload)
        if isinstance(payload, (bytes, bytearray)):
            try:
                payload = payload.decode("utf-8")
            except UnicodeDecodeError:
                return None
        if isinstance(payload, str):
            s = payload.strip()
            if s.startswith("{"):
                try:
                    obj = json.loads(s)
                except json.JSONDecodeError:
                    return None
                return _from_mapping(obj) if isinstance(obj, dict) else None
            return _from_csv(s)
        return None

    def json_only(payload):
        """Pinned JSON contract: a dict, or a string/bytes holding a JSON
        object — anything else (CSV lines included) is malformed, not
        silently re-interpreted."""
        if isinstance(payload, dict):
            return _from_mapping(payload)
        if isinstance(payload, (bytes, bytearray)):
            try:
                payload = payload.decode("utf-8")
            except UnicodeDecodeError:
                return None
        if isinstance(payload, str):
            try:
                obj = json.loads(payload)
            except json.JSONDecodeError:
                return None
            return _from_mapping(obj) if isinstance(obj, dict) else None
        return None

    return {"auto": auto, "json": json_only, "csv": _from_csv}


class ProbeFormatter:
    """Normalizes raw vendor payloads into canonical probe records."""

    def __init__(self, fmt: str = "auto"):
        self._formats = _default_formats()
        self.fmt = fmt
        if fmt not in self._formats:
            raise ValueError(f"unknown format {fmt!r}; "
                             f"have {sorted(self._formats)}")
        self.normalized = 0
        self.dropped = 0

    def register(self, name: str, fn: FormatFn) -> None:
        """Plug in a vendor-specific format (fn: payload → record|None)."""
        self._formats[name] = fn

    def normalize(self, payload: Any, fmt: "str | None" = None,
                  ) -> "dict | None":
        name = fmt or self.fmt
        if name not in self._formats:   # per-call override gets the same
            raise ValueError(           # validation the constructor does
                f"unknown format {name!r}; have {sorted(self._formats)}")
        try:
            rec = self._formats[name](payload)
        except Exception:
            # a poison payload (or a buggy registered format fn) must
            # never wedge the stream — drop and count, as documented
            rec = None
        if rec is None:
            self.dropped += 1
        else:
            self.normalized += 1
        return rec

    def normalize_columns(self, payloads, fmt: "str | None" = None):
        """Normalize raw payloads into ONE ProbeColumns batch (the
        columnar ingest path, streaming/columnar.py). Vendor parsing is
        inherently per-payload Python — the win is downstream: the batch
        enters the broker and the matcher worker as flat columns, so the
        per-record cost stops at this (formatter-worker) stage instead of
        riding the matcher worker's core."""
        from reporter_tpu_torch.streaming.columnar import pack_records

        recs = []
        for p in payloads:
            rec = self.normalize(p, fmt)
            if rec is not None:
                recs.append(rec)
        return pack_records(recs)

    def format_stream(self, payloads, queue, fmt: "str | None" = None,
                      ) -> int:
        """Normalize raw payloads into ``queue`` (any object with the
        IngestQueue producer surface — records route by uuid AFTER
        normalization). Returns the number of records appended."""
        n = 0
        for p in payloads:
            rec = self.normalize(p, fmt)
            if rec is not None:
                queue.append(rec)
                n += 1
        return n

    def format_stream_columns(self, payloads, queue,
                              fmt: "str | None" = None,
                              chunk: int = 4096) -> int:
        """format_stream's batch sibling for columnar brokers: normalize
        ``chunk`` payloads at a time and append each chunk as ONE column
        batch (queue.append_columns), so the durable log stores column
        frames instead of one frame per record. Returns records appended."""
        n = 0
        pending: list = []

        def flush():
            nonlocal n
            cols = self.normalize_columns(pending, fmt)
            queue.append_columns(cols)
            n += cols.n
            pending.clear()

        for p in payloads:
            pending.append(p)
            if len(pending) >= chunk:
                flush()
        if pending:
            flush()
        return n

    def stats(self) -> dict:
        return {"normalized": self.normalized, "dropped": self.dropped}
