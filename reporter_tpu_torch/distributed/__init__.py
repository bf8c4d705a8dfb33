"""The supervised streaming topology: the supervisor (supervisor.py),
cross-worker metrics aggregation over atomically spooled snapshots
(aggregate.py and utils/metrics.merge_exports), cross-pid trace
stitching (stitch.py), and the epoch-fenced partition lease table that
makes membership elastic (lease.py). See DISTRIBUTED.md "Topology
observability" and "Partition leasing".

Counterpart: reporter_tpu/distributed/__init__.py, with the same
exports."""

from reporter_tpu_torch.distributed.lease import (LeaseError, LeaseRunner,
                                                  LeaseTable,
                                                  StaleLeaseError,
                                                  plan_rebalance)
from reporter_tpu_torch.distributed.supervisor import (MemberSpec,
                                                       ReportSink,
                                                       Supervisor,
                                                       worker_member)

__all__ = ["MemberSpec", "ReportSink", "Supervisor", "worker_member",
           "LeaseTable", "LeaseRunner", "LeaseError", "StaleLeaseError",
           "plan_rebalance"]
