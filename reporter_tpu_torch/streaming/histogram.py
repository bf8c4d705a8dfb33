"""Device-resident per-segment speed histograms (BASELINE config 5).

Counterpart: reporter_tpu/streaming/histogram.py (``SpeedHistogram``).
The live histogram stays on the device: an i32 [G, B] tensor that every
flush scatters into with ``index_add_`` on the flattened index ``row *
num_bins + bin``. The JAX package pads each update to a fixed 4096-row
shape for jit; torch compiles nothing per shape, so the port scatters
each update whole. Integer adds are exact, so the counts do not depend
on the order of the updates. ``snapshot()`` is the only copy of the
state back to the host (histogram flushes and checkpoints call it, a
wave never does).
"""

from __future__ import annotations

import numpy as np
import torch

from reporter_tpu_torch.device import resolve_device


class SpeedHistogram:
    """i32 [num_rows, num_bins] observation counts on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``); bin = speed (m/s) bucket,
    the last bin open-ended."""

    def __init__(self, num_rows: int, bin_edges: tuple[float, ...],
                 device: "str | torch.device | None" = None):
        self.bin_edges = np.asarray(bin_edges, np.float64)
        self.num_bins = len(bin_edges)
        self.num_rows = int(num_rows)
        self.device = resolve_device(device)
        self._hist = torch.zeros((self.num_rows, self.num_bins),
                                 dtype=torch.int32, device=self.device)

    def update(self, rows: np.ndarray, speeds: np.ndarray) -> None:
        """Add one observation per (segment row, speed m/s) pair. Bins come
        from ``searchsorted(side="right") - 1`` in f64 on the host; a row
        outside [0, num_rows) or a speed below the first edge adds 0 (at a
        clamped index, as the JAX scatter does)."""
        if len(rows) == 0 or self.num_rows == 0:
            return
        rows = np.asarray(rows, np.int32)
        bins = (np.searchsorted(self.bin_edges, np.asarray(speeds),
                                side="right") - 1).astype(np.int32)
        ok = (rows >= 0) & (rows < self.num_rows) & (bins >= 0)
        # clamp as the JAX scatter's index does: a row past the end lands
        # on the last row, adding 0 there
        r = np.clip(rows.astype(np.int64), 0, self.num_rows - 1)
        flat = r * self.num_bins + np.maximum(bins, 0)
        # one host-to-device copy each of the index and the 0/1 weights,
        # queued with the scatter on the calling thread's current stream,
        # in order (pageable sources: each copy has read its host buffer
        # before it returns)
        idx = torch.from_numpy(flat).to(self.device)
        upd = torch.from_numpy(ok.astype(np.int32)).to(self.device)
        self._hist.view(-1).index_add_(0, idx, upd)

    def snapshot(self) -> np.ndarray:
        """Host copy [num_rows, num_bins] (i32): owned, never a view of the
        live tensor (on the CPU ``.cpu()`` would return the tensor itself,
        and a later update would move the caller's baseline)."""
        return self._hist.to("cpu", copy=True).numpy()

    def load(self, hist: np.ndarray) -> None:
        assert hist.shape == (self.num_rows, self.num_bins)
        # an owned copy: the live tensor must not alias the caller's array
        self._hist = torch.from_numpy(
            np.array(hist, np.int32, copy=True)).to(self.device)

    def nonzero_rows(self) -> np.ndarray:
        """Rows with any observation, found on the device: only their
        indices come back, not the state (stats() reads this per step)."""
        rows = torch.nonzero(self._hist.sum(dim=1)).flatten()
        return rows.cpu().numpy()
