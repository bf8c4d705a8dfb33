"""Scale-out: device meshes, sharded matchers, multi-metro dispatch.

Counterpart: reporter_tpu/parallel/. The mapping onto CUDA devices:

  data parallelism   → batch rows split over the mesh's flattened
                       ("tile", "dp") axes, one wire entry per shard
                       (BASELINE configs 2-3: dp.py, dp_e2e.py)
  sharded state (EP) → each "tile" shard holds whole metros' tables;
                       probes are dispatched to their metro's shard on
                       the host (BASELINE config 4: multimetro.py)
  sharded segments   → a metro's segment table split over an axis, the
                       per-shard K-lists gathered and merged
                       (sharded_candidates.py)
  collectives        → within a process, gathers and i32 sums of tensors
                       copied to one device; between processes,
                       ``torch.distributed`` (multihost.py)

The mesh is a process-local array of ``torch.device`` (mesh.py), which
may repeat a device. The reference's ``parallel/compat.py`` bridges two
JAX versions of ``shard_map`` and has no counterpart here: each program
dispatches its shards itself.
"""

from reporter_tpu_torch.parallel.dp import make_dp_matcher
from reporter_tpu_torch.parallel.dp_e2e import DpWireMatcher
from reporter_tpu_torch.parallel.mesh import make_mesh
from reporter_tpu_torch.parallel.multimetro import (MetroBatch, StackedTiles,
                                                    dispatch_traces,
                                                    make_multimetro_matcher,
                                                    stack_tilesets)
from reporter_tpu_torch.parallel.sharded_candidates import (
    make_sharded_matcher)

__all__ = [
    "DpWireMatcher",
    "make_sharded_matcher",
    "make_mesh",
    "make_dp_matcher",
    "MetroBatch",
    "StackedTiles",
    "dispatch_traces",
    "make_multimetro_matcher",
    "stack_tilesets",
]
