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
and returns an owned array; ``load()`` takes an owned copy.

``FixedGridCounts(size, mesh=...)`` keeps a per-device partial grid: an
i32 [ndev, size] partial, row d on the d-th device of the mesh's
flattened data axis (parallel/dp_e2e), with the index stream split into
_CAP-index blocks taken by the shards in turn, as the JAX package's
[ndev, _CAP] dispatch splits it. Each shard scatters into its own
partial, with no traffic between devices; ``snapshot()`` sums the
partials in i32 (unit increments commute, so the merged grid equals the
single-device one, wrap included). ``load()`` puts the whole grid in
partial row 0: rows are partials, not owners.
"""

from __future__ import annotations

import numpy as np
import torch

from reporter_tpu_torch.device import resolve_device

# indices a shard takes at a time on a mesh: the JAX package's per-shard
# update block, so each partial receives the indices its JAX twin does
_CAP = 4096


class FixedGridCounts:
    """i32 [size] counts on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``), or on a ``mesh`` as per-device partials (module
    docstring; ``device`` must then be None or the mesh's first device);
    ``add()`` scatters host-binned flat cell indices."""

    def __init__(self, size: int, mesh=None,
                 device: "str | torch.device | None" = None):
        self.size = int(size)
        if not 0 < self.size < 2 ** 31:      # the i32 index space
            raise ValueError(f"grid size {self.size} outside (0, 2**31)")
        self.mesh = mesh
        if mesh is None:
            self.devices = [resolve_device(device)]
        else:
            self.devices = mesh.flat_devices
            if device is not None and torch.device(device) != self.devices[0]:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"first device {self.devices[0]}")
        self.device = self.devices[0]
        self.ndev = len(self.devices)
        self._parts = [torch.zeros(self.size, dtype=torch.int32, device=d)
                       for d in self.devices]

    def add(self, idx: np.ndarray) -> int:
        """One observation per flat index → the accepted count. Queued on
        the calling thread's current stream of each device; no
        readback."""
        if len(idx) == 0:
            return 0
        idx = np.asarray(idx, np.int64)
        ok = (idx >= 0) & (idx < self.size)
        flat = np.clip(idx, 0, self.size - 1)
        if self.ndev == 1:
            self._scatter(0, flat, ok)
        else:
            # _CAP-index blocks to the shards in turn
            block = np.arange(len(flat)) // _CAP % self.ndev
            for d in range(self.ndev):
                sel = block == d
                if sel.any():
                    self._scatter(d, flat[sel], ok[sel])
        return int(ok.sum())

    def _scatter(self, d: int, flat: np.ndarray, ok: np.ndarray) -> None:
        dev = self.devices[d]
        self._parts[d].index_add_(
            0, torch.from_numpy(flat).to(dev),
            torch.from_numpy(ok.astype(np.int32)).to(dev))

    def partials(self) -> np.ndarray:
        """Host copy [ndev, size] (i32) of the per-device partials."""
        return np.stack([p.to("cpu", copy=True).numpy()
                         for p in self._parts])

    def snapshot(self) -> np.ndarray:
        """Host copy [size] (i32), never a view of the live tensor; on a
        mesh the partials' i32 sum."""
        if self.ndev == 1:
            return self._parts[0].to("cpu", copy=True).numpy()
        return self.partials().sum(axis=0, dtype=np.int32)

    def load(self, grid: np.ndarray) -> None:
        """Take a whole (merged) grid: on a mesh into partial row 0, the
        other partials zeroed."""
        grid = np.asarray(grid).reshape(-1)
        if grid.shape != (self.size,):
            raise ValueError(f"grid of {grid.shape} cells, expected "
                             f"({self.size},)")
        self._parts = [torch.from_numpy(
            np.array(grid, np.int32, copy=True)).to(self.devices[0])] + [
            torch.zeros(self.size, dtype=torch.int32, device=d)
            for d in self.devices[1:]]


def reference_counts(size: int, idx: np.ndarray) -> np.ndarray:
    """The plain accumulation: what a FixedGridCounts snapshot must equal
    after add(idx) from zero."""
    grid = np.zeros(int(size), np.int32)
    idx = np.asarray(idx, np.int64)
    ok = (idx >= 0) & (idx < size)
    np.add.at(grid, idx[ok], np.int32(1))
    return grid
