"""Data-parallel matcher: the batch axis sharded over the mesh (config 3).

Counterpart: reporter_tpu/parallel/dp.py. The tile tables are
replicated to every distinct device once (they are read-only); each call
shards the traces over "tile" x "dp" as one flat data axis and runs the
whole matcher (``ops.match.match_traces``: the sweep kernel, the
Viterbi) on each shard's rows on its own device. No communication
between shards in the forward match, which is why data parallelism is
the first-choice scaling axis for this workload.
"""

from __future__ import annotations

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.ops.match import MatchOutput, match_traces
from reporter_tpu_torch.parallel.dp_e2e import (_row_blocks,
                                                flat_device_count,
                                                replicate_tables)
from reporter_tpu_torch.parallel.mesh import Mesh


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def gather(parts: "list[MatchOutput]", device: torch.device) -> MatchOutput:
    """Per-shard MatchOutputs concatenated along rows on ``device``."""
    return MatchOutput(*(torch.cat([getattr(p, f).to(device) for p in parts])
                         for f in MatchOutput._fields))


def make_dp_matcher(mesh: Mesh, ts, params: MatcherParams):
    """→ step(points [B, T, 2], valid [B, T]) → MatchOutput [B, T],
    gathered on the mesh's first device, with the batch sharded over
    every mesh axis. B must be a multiple of the mesh's device count
    (pad with valid=False rows on the host). Inputs are host arrays or
    tensors."""
    ndev = flat_device_count(mesh)
    devices = mesh.flat_devices
    tables = replicate_tables(mesh, ts.host_tables(params.candidate_backend))
    meta = ts.meta

    def step(points, valid) -> MatchOutput:
        B = points.shape[0]
        if B % ndev:
            raise ValueError(f"batch of {B} rows is not a multiple of the "
                             f"mesh's {ndev} devices; pad with valid=False "
                             "rows")
        parts = [match_traces(as_tensor(points[rows], dev),
                              as_tensor(valid[rows], dev), tables[dev],
                              params, None, meta)
                 for dev, rows in zip(devices, _row_blocks(B, ndev))]
        return gather(parts, devices[0])

    return step
