"""Backfill aggregates: per-segment speed × time-of-day histograms and
next-segment turn counts, on the device.

Counterpart: reporter_tpu/backfill/aggregate.py (``SpeedTodHistogram``,
``TurnCounts``, ``harvest_aggregates``, ``AggregateStore``). Both grids
are FixedGridCounts (ops/aggregate.py), per-device partials on a
``mesh``; this module owns the host-side binning that turns an
observation into a flat cell index. The binning
has one spelling per grid (``flat_cells``), shared by the device scatter
and the numpy reference, so a device-against-reference check isolates
the scatter.

Turn counts take a host-side, first-seen slot legend per segment row;
successors past ``slots`` land in the counted "other" slot, never
dropped. The k-anonymity cutoff (``harvest_aggregates``) runs once at
harvest: a segment below k is absent from the document, never present
with zeros, which would tell that it was observed.
"""

from __future__ import annotations

import numpy as np
import torch

from reporter_tpu_torch.ops.aggregate import (FixedGridCounts,
                                              reference_counts)
from reporter_tpu_torch.utils import locks

DEFAULT_TOD_BINS = 24
DEFAULT_TURN_SLOTS = 8

_DAY_S = 86400.0


class SpeedTodHistogram:
    """i32 [rows, tod_bins, speed_bins] counts on ``device`` (a flat
    grid); the last speed bin is open-ended."""

    def __init__(self, num_rows: int, speed_edges,
                 tod_bins: int = DEFAULT_TOD_BINS, mesh=None,
                 device: "str | torch.device | None" = None):
        self.speed_edges = np.asarray(speed_edges, np.float64)
        self.num_bins = len(self.speed_edges)
        self.tod_bins = int(tod_bins)
        self.num_rows = int(num_rows)
        self._grid = FixedGridCounts(
            self.num_rows * self.tod_bins * self.num_bins, mesh=mesh,
            device=device)

    def flat_cells(self, rows, times, speeds) -> np.ndarray:
        """The binning: (segment row, start time s, speed m/s) → flat
        cell index; -1 where no cell accepts the observation (an unknown
        row, a speed below the first edge)."""
        rows = np.asarray(rows, np.int64)
        tod = np.floor(np.mod(np.asarray(times, np.float64), _DAY_S)
                       / (_DAY_S / self.tod_bins)).astype(np.int64)
        tod = np.clip(tod, 0, self.tod_bins - 1)
        sbin = (np.searchsorted(self.speed_edges, np.asarray(speeds),
                                side="right") - 1).astype(np.int64)
        ok = (rows >= 0) & (rows < self.num_rows) & (sbin >= 0)
        return np.where(ok, (rows * self.tod_bins + tod) * self.num_bins
                        + sbin, -1)

    def update(self, rows, times, speeds) -> int:
        """One observation per (row, time, speed) → the accepted count.
        Device work only, no readback."""
        if len(np.asarray(rows)) == 0:
            return 0
        return self._grid.add(self.flat_cells(rows, times, speeds))

    def snapshot(self) -> np.ndarray:
        return self._grid.snapshot().reshape(
            self.num_rows, self.tod_bins, self.num_bins)

    def load(self, hist) -> None:
        """Take a flat or [rows, tod_bins, speed_bins] snapshot (a
        checkpoint of either package)."""
        self._grid.load(np.asarray(hist))

    def reference(self, rows, times, speeds) -> np.ndarray:
        """The numpy accumulation from zero over the same observations."""
        return reference_counts(
            self._grid.size, self.flat_cells(rows, times, speeds)).reshape(
                self.num_rows, self.tod_bins, self.num_bins)


class TurnCounts:
    """i32 [rows, slots + 1] next-segment counts on ``device`` (a flat
    grid). The slot legend (row → successor segment ids, first seen
    first) lives on the host and rides checkpoints in the cache dump."""

    def __init__(self, num_rows: int, slots: int = DEFAULT_TURN_SLOTS,
                 mesh=None, device: "str | torch.device | None" = None):
        self.num_rows = int(num_rows)
        self.slots = int(slots)
        self._grid = FixedGridCounts(self.num_rows * (self.slots + 1),
                                     mesh=mesh, device=device)
        self._legend: "dict[int, list[int]]" = {}

    def _slot(self, row: int, next_id: int) -> int:
        lst = self._legend.setdefault(row, [])
        try:
            return lst.index(next_id)
        except ValueError:
            if len(lst) < self.slots:
                lst.append(next_id)
                return len(lst) - 1
            return self.slots            # the counted "other" slot

    def flat_cells(self, rows, next_ids) -> np.ndarray:
        """(segment row, successor segment id) → flat cell; -1 without a
        successor (next id < 0) or for an unknown row. The Python loop
        runs over the distinct (row, successor) pairs only, in sorted
        order."""
        rows = np.asarray(rows, np.int64)
        next_ids = np.asarray(next_ids, np.int64)
        ok = (rows >= 0) & (rows < self.num_rows) & (next_ids >= 0)
        out = np.full(len(rows), -1, np.int64)
        if not ok.any():
            return out
        pairs = np.stack([rows[ok], next_ids[ok]], axis=1)
        uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
        slots = np.asarray([self._slot(int(r), int(n)) for r, n in uniq],
                           np.int64)
        out[ok] = rows[ok] * (self.slots + 1) + slots[inverse.reshape(-1)]
        return out

    def update(self, rows, next_ids) -> int:
        if len(np.asarray(rows)) == 0:
            return 0
        return self._grid.add(self.flat_cells(rows, next_ids))

    def snapshot(self) -> np.ndarray:
        return self._grid.snapshot().reshape(self.num_rows, self.slots + 1)

    def load(self, counts) -> None:
        self._grid.load(np.asarray(counts))

    def dump_legend(self) -> dict:
        """The legend as JSON for the checkpoint's cache dump."""
        return {str(r): [int(n) for n in lst]
                for r, lst in self._legend.items()}

    def load_legend(self, dumped: dict) -> None:
        self._legend = {int(r): [int(n) for n in lst]
                        for r, lst in (dumped or {}).items()}

    def reference(self, rows, next_ids) -> np.ndarray:
        return reference_counts(
            self._grid.size, self.flat_cells(rows, next_ids)).reshape(
                self.num_rows, self.slots + 1)


def harvest_aggregates(hist: SpeedTodHistogram, turns: TurnCounts,
                       osmlr_ids: np.ndarray, k: int) -> dict:
    """One readback per grid and the k-anonymity cutoff → the document.

    A segment's aggregate is kept only when that aggregate's own total
    reaches ``k`` (k = 0 still needs one observation). A withheld segment
    is absent, never zeroed, and counted in ``kanon_dropped``."""
    k = int(k)
    thresh = max(k, 1)
    h = hist.snapshot()
    t = turns.snapshot()
    h_tot = h.sum(axis=(1, 2))
    t_tot = t.sum(axis=1)
    keep_h = h_tot >= thresh
    keep_t = t_tot >= thresh
    observed = (h_tot > 0) | (t_tot > 0)
    dropped = int((observed & ~keep_h & ~keep_t).sum())
    segments: "dict[str, dict]" = {}
    for r in np.nonzero(keep_h | keep_t)[0]:
        seg: "dict[str, object]" = {}
        if keep_h[r]:
            seg["observations"] = int(h_tot[r])
            seg["speed_tod"] = h[r].astype(int).tolist()
        if keep_t[r]:
            lst = turns._legend.get(int(r), [])
            counts = {str(nid): int(t[r, s]) for s, nid in enumerate(lst)
                      if t[r, s] > 0}
            seg["turns"] = {"total": int(t_tot[r]), "counts": counts,
                            "other": int(t[r, turns.slots])}
        segments[str(int(osmlr_ids[r]))] = seg
    return {
        "k_anonymity": k,
        "tod_bins": hist.tod_bins,
        "speed_bin_edges": hist.speed_edges.tolist(),
        "turn_slots": turns.slots,
        "segments": segments,
        "kanon_dropped": dropped,
    }


class AggregateStore:
    """Thread-safe holder of the latest harvested document, which GET
    /aggregates serves. Install, then read; never touches the device."""

    def __init__(self):
        self._lock = locks.named_lock("backfill.aggregates")
        self._doc: "dict | None" = None

    def install(self, doc: dict) -> None:
        with self._lock:
            self._doc = doc

    def snapshot(self, segment: "str | None" = None) -> "dict | None":
        """The whole document, or one segment's block with the grid's
        metadata (None when nothing is installed or the segment is
        unknown)."""
        with self._lock:
            doc = self._doc
        if doc is None:
            return None
        if segment is None:
            return doc
        seg = doc["segments"].get(str(segment))
        if seg is None:
            return None
        return {k: v for k, v in doc.items() if k != "segments"} | {
            "segment_id": str(segment), "aggregate": seg}
