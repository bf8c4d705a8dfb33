"""The device mesh: how devices become the logical axes ("tile", "dp").

Counterpart: reporter_tpu/parallel/mesh.py. A ``Mesh`` is a [tile, dp]
array of ``torch.device`` with ``axis_names == ("tile", "dp")``;
``dict(mesh.shape)`` is ``{"tile": t, "dp": d}``, as a JAX mesh's is.

  ("tile", 1 x dp)  pure data parallelism (BASELINE config 3)
  ("tile" x "dp")   metro or segment shards x data parallelism (config 4)

The mesh lives in one process: each program of this package dispatches
every shard's work from the calling thread, to each shard's device in
turn, and gathers the results itself. ``devices=`` may repeat a device:
``make_mesh(dp=4, devices=["cuda:0"] * 4)`` runs the whole sharding path
(padding, per-shard dispatch, gather, K-merge, histogram reduce) on one
card, and ``devices=["cpu"] * 8`` on the host. That is the stand-in for
the virtual CPU devices JAX gets from
``--xla_force_host_platform_device_count`` (a deliberate divergence:
a shard on a repeated device runs after the one before it, where JAX's
virtual devices are separate executors).
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A [tile, dp] array of ``torch.device`` over the axes ("tile",
    "dp"). ``devices`` is the numpy object array; ``flat_devices`` the
    devices in row-major order (the order the data axis shards rows
    over); ``distinct_devices`` each device once, in first-seen order."""

    axis_names = ("tile", "dp")

    def __init__(self, devices: np.ndarray):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty [tile, dp] array of "
                             f"devices, got shape {arr.shape}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> "list[torch.device]":
        return list(self.devices.reshape(-1))

    @property
    def distinct_devices(self) -> "list[torch.device]":
        return list(dict.fromkeys(self.flat_devices))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.flat_devices]})")


def _checked(device) -> torch.device:
    """A mesh entry as a torch.device: ``cpu``, or a CUDA card that is
    present (``cuda`` alone is card 0)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}; use 'cuda:N' "
                         "or 'cpu'")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    idx = 0 if dev.index is None else dev.index
    if idx >= n:
        raise RuntimeError(f"mesh device {device!r} requested but this host "
                           f"has {n} CUDA device(s)")
    return torch.device("cuda", idx)


def make_mesh(tile: int = 1, dp: "int | None" = None,
              devices=None) -> Mesh:
    """Build a ("tile", "dp") mesh over ``tile * dp`` devices.

    ``devices`` defaults to every visible card by index (``cuda:0`` ..
    ``cuda:n-1``) and raises without one; pass it to name the devices,
    repeats allowed (``["cpu"] * 8``, ``["cuda:0"] * 4``). dp=None uses
    all remaining devices; tile=1 is data-parallel only (the "tile" axis
    still exists, of size 1). The JAX package's ValueErrors: a device
    count that ``tile`` does not divide, or more devices needed than
    given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. ['cpu'] * 8) to build a host mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_checked(d) for d in devices]
    if dp is None:
        if len(devices) % tile:
            raise ValueError(
                f"{len(devices)} devices not divisible by tile={tile}")
        dp = len(devices) // tile
    need = tile * dp
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(tile, dp))
