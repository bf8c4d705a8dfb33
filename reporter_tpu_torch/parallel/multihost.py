"""Multi-host bootstrap: the process-group half of DISTRIBUTED.md.

Counterpart: reporter_tpu/parallel/multihost.py. Processes join one
``torch.distributed`` process group (``nccl`` for a CUDA process,
``gloo`` on the CPU) through a TCP rendezvous at the coordinator's
address, from explicit arguments or the environment (the k8s / compose
shape: every replica gets the same manifest plus its ordinal):

  REPORTER_TPU_COORDINATOR    host:port of process 0 (e.g. "gpu-0:8476")
  REPORTER_TPU_NUM_PROCESSES  total process count
  REPORTER_TPU_PROCESS_ID     this process's ordinal (0-based)

A single process (none of the above set) is a no-op: the local devices
already form the whole mesh. A mesh (parallel/mesh.py) stays within one
process; the group carries collectives between processes. As in the
JAX package, runs across hosts are checked by design only; a group of
processes on one host runs in the tests (``gloo``) and on the card
(``nccl``, one process).
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("reporter_tpu_torch.multihost")


def initialize_multihost(coordinator: "str | None" = None,
                         num_processes: "int | None" = None,
                         process_id: "int | None" = None) -> bool:
    """Join (or host) the process group; True iff one was joined.

    Unset arguments fall back to the REPORTER_TPU_* variables. Returns
    False for a single process (nothing to join). The backend is
    ``nccl`` when a card is present, else ``gloo``."""
    env = os.environ
    coordinator = coordinator or env.get("REPORTER_TPU_COORDINATOR") or None
    if num_processes is None and env.get("REPORTER_TPU_NUM_PROCESSES"):
        num_processes = int(env["REPORTER_TPU_NUM_PROCESSES"])
    if process_id is None and env.get("REPORTER_TPU_PROCESS_ID"):
        process_id = int(env["REPORTER_TPU_PROCESS_ID"])

    if coordinator is None:
        # half-configured is the dangerous state: a group-shaped setting
        # without a coordinator is a typoed manifest, and N disjoint
        # single-process meshes would hide it
        if num_processes not in (None, 1) or process_id is not None:
            raise ValueError(
                f"num_processes={num_processes} / process_id={process_id} "
                "but no coordinator address (set REPORTER_TPU_COORDINATOR "
                "on every process)")
        return False
    # both required: a mis-templated manifest fails here with a clear
    # message, not deep inside the rendezvous
    if num_processes is None or process_id is None:
        raise ValueError(
            "coordinator set but num_processes/process_id missing (set "
            "REPORTER_TPU_NUM_PROCESSES and the per-replica "
            "REPORTER_TPU_PROCESS_ID)")

    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    log.info("joined process group: process %d/%d via %s (%s)",
             dist.get_rank(), dist.get_world_size(), coordinator, backend)
    return True


def shutdown_multihost() -> None:
    """Leave the process group (idempotent; a no-op when never joined)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
