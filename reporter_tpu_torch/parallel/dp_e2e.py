"""The mesh-aware wire backend: the multi-device product path (configs
3-4).

Counterpart: reporter_tpu/parallel/dp_e2e.py. ``SegmentMatcher(ts,
mesh=mesh)`` routes every device dispatch through a ``DpWireMatcher``,
whose entries run the SAME wire bodies the single-device path runs
(``ops.match.wire_from_*``), once per shard: there is no second wire
body. Everything downstream (harvest, unpack, the C walk, the columnar
MatchBatch, report build, the service layers) reads the same wire
format, so the mesh's records equal the single-device matcher's.

Layout (the JAX package's DP row): batch rows over every mesh axis
flattened into one data axis, in the mesh's row-major device order; the
tile tables replicated, placed once per distinct device (a repeated
device shares one copy). No communication between shards per dispatch.

A batch whose row count is not a multiple of the device count is padded
with zero rows (``acc`` with ones, as the reference pads it); the
harvest slices wires back to the real row count, so callers never see
the padding. The harvest reads one host array in row order
(``ShardedWire.cpu``). The reference's ``data_pspec`` (the
PartitionSpec of that data axis) and ``mesh_wire_fn`` (its
jit(shard_map) program) have no torch meaning: here the split is
``_row_blocks`` and each shard calls the wire body directly.
"""

from __future__ import annotations

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.device import host_to_device
from reporter_tpu_torch.ops import match as match_ops
from reporter_tpu_torch.parallel.mesh import Mesh
from reporter_tpu_torch.tiles.tileset import device_members, place_tables

_IMPLS = {"f32": match_ops.wire_from_f32, "q16": match_ops.wire_from_q16,
          "q8": match_ops.wire_from_q8}


def flat_device_count(mesh: Mesh) -> int:
    """Devices under the flattened data axis (rows per padded dispatch
    block)."""
    return int(np.prod(tuple(mesh.shape.values())))


def _row_blocks(n_rows: int, n_shards: int) -> "list[slice]":
    """The data axis' split of ``n_rows`` (a multiple of ``n_shards``)
    into equal consecutive blocks, shard i the i-th."""
    per = n_rows // n_shards
    return [slice(i * per, (i + 1) * per) for i in range(n_shards)]


def replicate_tables(mesh: Mesh, host: dict) -> "dict[torch.device, dict]":
    """A host staged dict placed once on each distinct device of the
    mesh → {device: its tensors}."""
    return {dev: device_members(place_tables(host, dev))
            for dev in mesh.distinct_devices}


class ShardedWire:
    """One dispatch's wire, one tensor per shard (each on its shard's
    device, rows in data-axis order). ``cpu()`` is the harvest: every
    shard's copy to the host, concatenated in row order."""

    def __init__(self, shards: "list[torch.Tensor]"):
        self.shards = shards

    def cpu(self) -> torch.Tensor:
        return torch.cat([w.cpu() for w in self.shards])


class DpWireMatcher:
    """The single-device wire entries' duck type: ``f32`` / ``q16`` /
    ``q8`` on host numpy arrays, returning a ShardedWire (padded rows
    possible: the harvest slices to the caller's row count)."""

    def __init__(self, mesh: Mesh, ts, params: MatcherParams,
                 spec: "tuple | None"):
        self.mesh = mesh
        self.ndev = flat_device_count(mesh)
        self.meta = ts.meta
        self.params = params
        self.spec = spec
        self.devices = mesh.flat_devices
        # replicated once per distinct device; only the resolved
        # backend's layout (the unused one is the largest table at metro
        # scale)
        self.tables = replicate_tables(
            mesh, ts.host_tables(params.candidate_backend))

    # ---- public entries (the single-device wire entries' shapes) --------

    def f32(self, pts, lens, acc):
        return self._dispatch("f32", (pts, lens), acc)

    def q16(self, pts_q, origins, lens, acc):
        return self._dispatch("q16", (pts_q, origins, lens), acc)

    def q8(self, deltas_q, origins, lens, acc):
        return self._dispatch("q8", (deltas_q, origins, lens), acc)

    # ---- internals --------------------------------------------------------

    def _dispatch(self, kind: str, arrays, acc) -> ShardedWire:
        return self.run(kind, self.stage(arrays, acc))

    def stage(self, arrays, acc) -> list:
        """The host half of a dispatch: rows padded to a multiple of the
        devices, split in data-axis order and copied to each shard's
        device → [(device, args, acc)] per shard."""
        B = arrays[0].shape[0]
        pad = (-B) % self.ndev
        if pad:
            arrays = tuple(
                np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                for a in arrays)
            if acc is not None:
                acc = np.concatenate(
                    [acc, np.ones((pad,) + acc.shape[1:], acc.dtype)])
        staged = []
        for dev, rows in zip(self.devices,
                             _row_blocks(B + pad, self.ndev)):
            args = [host_to_device(np.ascontiguousarray(a[rows]), dev)
                    for a in arrays]
            a = (None if acc is None else
                 host_to_device(np.ascontiguousarray(acc[rows]), dev))
            staged.append((dev, args, a))
        return staged

    def run(self, kind: str, staged: list) -> ShardedWire:
        """The device half: one ``ops.match.wire_from_<kind>`` per shard
        on its staged rows (the mesh's wire program, audited by
        analysis/device_contract.py)."""
        impl = _IMPLS[kind]
        return ShardedWire([impl(*args, self.tables[dev], self.params, a,
                                 self.spec, self.meta)
                            for dev, args, a in staged])
