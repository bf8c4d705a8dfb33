"""Fixed-grid device counts: the scatter under backfill's aggregates.

Counterpart: reporter_tpu/ops/aggregate.py (``FixedGridCounts``,
``reference_counts``). An i32 flat [size] tensor on the device; callers
(backfill/aggregate.py) bin each observation to a flat cell index on the
host, and ``add()`` scatters one per index with one ``index_add_``, as
the port's SpeedHistogram does. An index outside [0, size) adds 0 at a
clamped index, as the JAX scatter masks it, and is counted as rejected.
The JAX package pads every update to a fixed 4096-index shape so that its
jit compiles once; torch compiles nothing per shape, so the port scatters
each update whole. Integer adds commute, so the grid does not depend on
how the index stream is split across calls.

``snapshot()`` is the only copy back to the host (harvest and checkpoint)
and returns an owned array; ``load()`` takes an owned copy. The mesh form
(per-device partial grids) waits for the multi-GPU port (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from reporter_tpu_torch.device import resolve_device


class FixedGridCounts:
    """i32 [size] counts on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``); ``add()`` scatters host-binned flat cell indices."""

    def __init__(self, size: int, mesh=None,
                 device: "str | torch.device | None" = None):
        if mesh is not None:
            raise NotImplementedError(
                "FixedGridCounts(mesh=...): per-device partial grids need "
                "the multi-GPU port: ROADMAP queue 1 item 7")
        self.size = int(size)
        if not 0 < self.size < 2 ** 31:      # the i32 index space
            raise ValueError(f"grid size {self.size} outside (0, 2**31)")
        self.device = resolve_device(device)
        self._grid = torch.zeros(self.size, dtype=torch.int32,
                                 device=self.device)

    def add(self, idx: np.ndarray) -> int:
        """One observation per flat index → the accepted count. Queued on
        the calling thread's current stream; no readback."""
        if len(idx) == 0:
            return 0
        idx = np.asarray(idx, np.int64)
        ok = (idx >= 0) & (idx < self.size)
        flat = np.clip(idx, 0, self.size - 1)
        self._grid.index_add_(
            0, torch.from_numpy(flat).to(self.device),
            torch.from_numpy(ok.astype(np.int32)).to(self.device))
        return int(ok.sum())

    def snapshot(self) -> np.ndarray:
        """Host copy [size] (i32), never a view of the live tensor."""
        return self._grid.to("cpu", copy=True).numpy()

    def load(self, grid: np.ndarray) -> None:
        grid = np.asarray(grid).reshape(-1)
        if grid.shape != (self.size,):
            raise ValueError(f"grid of {grid.shape} cells, expected "
                             f"({self.size},)")
        self._grid = torch.from_numpy(
            np.array(grid, np.int32, copy=True)).to(self.device)


def reference_counts(size: int, idx: np.ndarray) -> np.ndarray:
    """The plain accumulation: what a FixedGridCounts snapshot must equal
    after add(idx) from zero."""
    grid = np.zeros(int(size), np.int32)
    idx = np.asarray(idx, np.int64)
    ok = (idx >= 0) & (idx < size)
    np.add.at(grid, idx[ok], np.int32(1))
    return grid
