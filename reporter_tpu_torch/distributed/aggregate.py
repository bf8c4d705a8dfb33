"""Cross-worker metrics aggregation over spooled snapshot files.

Counterpart: reporter_tpu/distributed/aggregate.py (``write_snapshot``,
``read_snapshot``, ``load_dir``, ``merge_registry``,
``fleet_exposition``, ``member_health``), in the same file schema
(``SNAPSHOT_SCHEMA = 1``): either package reads the other's snapshots.

The transport is the filesystem: every process of a topology on one
host shares a disk, tmp+fsync+rename makes each snapshot an atomic
document (a tailer never sees a torn file this writer produced), and no
inter-process HTTP means a wedged worker cannot stall the supervisor's
scrape; the supervisor reads whatever snapshots exist, stamps their
age, and serves the merge.

Worker side:  ``write_snapshot(path, registry, member=...)``, called
              periodically by ``streaming.__main__`` when a snapshot dir
              is configured (``--snapshot-dir`` /
              ``RTPU_TOPO_SNAPSHOT_DIR``).
Supervisor:   ``load_dir(dir)`` tails every member's latest snapshot;
              ``merge_registry`` folds the K exports through
              ``utils.metrics.merge_exports``; ``fleet_exposition`` is
              the merged ``/metrics`` text; ``member_health`` is the
              per-member provenance block ``/health`` serves.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from reporter_tpu_torch.utils import metrics

__all__ = ["SNAPSHOT_SCHEMA", "write_snapshot", "read_snapshot",
           "load_dir", "merge_registry", "fleet_exposition",
           "member_health"]

SNAPSHOT_SCHEMA = 1


def snapshot_path(dirpath: str, member: str) -> str:
    """One file per member, overwritten in place (atomically): the
    supervisor wants each member's LATEST state, not a history — the
    histories live in the metrics themselves (counters/histograms are
    cumulative by construction, so no observation is lost to
    overwrites)."""
    return os.path.join(dirpath, f"{member}.json")


def write_snapshot(path: str, registry, member: str, seq: int = 0,
                   stats: "dict | None" = None) -> str:
    """Spool one atomic metrics/health snapshot (tmp+fsync+rename, the
    checkpoint discipline; a crash between any two syscalls leaves
    the previous snapshot intact, never a torn one)."""
    doc: "dict[str, Any]" = {
        "snapshot": "rtpu-member",
        "schema": SNAPSHOT_SCHEMA,
        "member": member,
        "pid": os.getpid(),
        "seq": int(seq),
        "written_at": time.time(),
        "metrics": registry.export(),
    }
    if stats is not None:
        doc["stats"] = stats
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_snapshot(path: str) -> "dict | None":
    """One member snapshot, or None when absent/unreadable/foreign.
    Unreadable is NOT an error path: our own writers are atomic, so a
    bad file is a foreign artifact in the spool dir — skipping it must
    never take the aggregation down."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("snapshot") != "rtpu-member":
        return None
    if doc.get("schema") != SNAPSHOT_SCHEMA:
        # the version tag exists to be CHECKED: a snapshot from a version-skewed member must be
        # skipped, never mis-merged into the fleet exposition
        return None
    return doc


def load_dir(dirpath: str) -> "dict[str, dict]":
    """member name → latest snapshot doc for every valid snapshot in
    the spool directory."""
    out: "dict[str, dict]" = {}
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        doc = read_snapshot(os.path.join(dirpath, name))
        if doc is not None:
            out[str(doc.get("member") or name[:-5])] = doc
    return out


def merge_registry(snapshots: "dict[str, dict]"):
    """K member snapshots → one fleet-wide MetricsRegistry (see
    utils.metrics.merge_exports for the math and its property-test
    contract)."""
    return metrics.merge_exports(
        {m: (doc.get("metrics") or {}) for m, doc in snapshots.items()})


def fleet_exposition(snapshots: "dict[str, dict]") -> str:
    """The merged Prometheus text — what the supervisor's /metrics
    serves."""
    return merge_registry(snapshots).render_prometheus()


def member_health(snapshots: "dict[str, dict]",
                  now: "float | None" = None) -> "dict[str, dict]":
    """Per-member snapshot provenance for /health: pid, seq, and
    snapshot LAG (age of the latest spool write — a member that stopped
    spooling is stale long before its process object says dead)."""
    now = time.time() if now is None else now
    out: "dict[str, dict]" = {}
    for m, doc in snapshots.items():
        written = float(doc.get("written_at") or 0.0)
        out[m] = {
            "pid": doc.get("pid"),
            "seq": doc.get("seq"),
            "snapshot_age_s": (round(now - written, 3) if written else None),
        }
    return out
