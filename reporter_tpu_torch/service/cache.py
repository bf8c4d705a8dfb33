"""Per-vehicle partial-trace cache.

Counterpart: reporter_tpu/service/cache.py (``PartialTraceCache``: TTL,
LRU, straddling-point retention, checkpoint ``dump`` / ``load``,
``drop``). Recent points are kept per ``uuid`` so segment traversals that
span several ``/report`` requests can still be reported as complete. It
is also the privacy boundary: points live at most ``ttl`` seconds and
only the tail needed to finish an in-progress segment is retained.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass

from reporter_tpu_torch.utils import locks


@dataclass
class _Entry:
    points: list[dict]              # [{"lat","lon","time"}…], ascending time
    wall: float                     # host wall-clock of last touch (eviction)


class PartialTraceCache:
    """Thread-safe TTL + LRU cache of per-uuid trailing trace points.

    ``merge`` prepends the cached tail to an incoming trace (deduping by
    timestamp); ``retain`` stores the tail that is still "in progress" after
    matching. ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, ttl: float = 60.0, max_uuids: int = 100_000,
                 max_points: int = 256, clock=time.monotonic):
        self.ttl = float(ttl)
        self.max_uuids = int(max_uuids)
        self.max_points = int(max_points)
        self._clock = clock
        self._lock = locks.named_lock("cache.entries")
        self._entries: OrderedDict[str, _Entry] = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def merge(self, uuid: str, points: list[dict]) -> list[dict]:
        """Cached tail + new points, ascending in time, deduped by time."""
        with self._lock:
            self._evict_locked()
            entry = self._entries.get(uuid)
            if entry is not None and self._clock() - entry.wall > self.ttl:
                del self._entries[uuid]     # expired but not yet at LRU front
                entry = None
            cached = list(entry.points) if entry is not None else []
        if not cached:
            return list(points)
        seen = {float(p["time"]) for p in cached}
        merged = cached + [p for p in points if float(p["time"]) not in seen]
        merged.sort(key=lambda p: float(p["time"]))
        return merged

    def retain(self, uuid: str, points: list[dict], from_time: float) -> None:
        """Keep points with time >= from_time as the uuid's pending tail.

        ``from_time`` is the end of the last *complete* segment the caller
        reported — anything earlier has been consumed and is dropped (privacy:
        reported history is never retained). The single point immediately
        before ``from_time`` is kept too: segment entry times are interpolated
        between GPS samples, so completing the in-progress segment on the next
        request needs the straddling pair, not just the points after the cut.
        """
        cut = 0
        for i, p in enumerate(points):
            if float(p["time"]) >= from_time:
                cut = max(0, i - 1)
                break
        else:
            cut = max(0, len(points) - 1)
        tail = points[cut:]
        tail = tail[-self.max_points:]
        with self._lock:
            if not tail:
                self._entries.pop(uuid, None)
                return
            self._entries[uuid] = _Entry(points=tail, wall=self._clock())
            self._entries.move_to_end(uuid)
            self._evict_locked()

    def dump(self) -> dict[str, dict]:
        """Snapshot {uuid: {points, age}} (the checkpoint form).

        ``age`` is seconds since last touch, so a restore into a new process
        (fresh clock) keeps the TTL privacy bound instead of resetting it.
        """
        now = self._clock()
        with self._lock:
            return {u: {"points": list(e.points), "age": now - e.wall}
                    for u, e in self._entries.items()}

    def load(self, state: dict[str, dict], extra_age: float = 0.0) -> None:
        """Restore a dump(); entries past the TTL are discarded.

        ``extra_age`` is time elapsed since the dump (e.g. outage duration
        from a wall-clock stamp) — monotonic ages alone can't see it.
        """
        now = self._clock()
        with self._lock:
            self._entries.clear()
            for u, rec in sorted(state.items(), key=lambda kv: -kv[1]["age"]):
                age = float(rec["age"]) + extra_age
                if age > self.ttl or not rec["points"]:
                    continue
                self._entries[u] = _Entry(points=list(rec["points"]),
                                          wall=now - age)
            self._evict_locked()

    def drop(self, uuid: str) -> None:
        """Forget ``uuid``'s pending tail (a no-op if none is cached)."""
        with self._lock:
            self._entries.pop(uuid, None)

    def _evict_locked(self) -> None:
        # retain() always move_to_end's, so the OrderedDict is ordered by
        # last-touch wall time: expired entries cluster at the front and
        # eviction is amortized O(evicted), not O(cached).
        now = self._clock()
        while self._entries:
            _, entry = next(iter(self._entries.items()))
            if now - entry.wall <= self.ttl:
                break
            self._entries.popitem(last=False)
        while len(self._entries) > self.max_uuids:
            self._entries.popitem(last=False)   # LRU
