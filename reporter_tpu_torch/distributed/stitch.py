"""Cross-process trace stitching: many flight-recorder dumps, ONE Chrome
trace.

Counterpart: reporter_tpu/distributed/stitch.py (``load_dump``,
``stitch``): the same document for the same dumps, whichever package
wrote them.

Every process of a topology dumps its own ring (utils/tracing.py): the
producer's ``produce`` spans carry the trace ids it stamped into broker
records (``tracing.stamp_record``), the workers' ``consume`` /
``worker_match`` spans carry the ids they inherited from those records.
Each dump's timestamps are that process's ``time.monotonic``, so a dump
carries a ``clock_sync`` anchor (one (monotonic, wall) pair taken at
dump time) and this module shifts every event onto the shared wall-clock
axis before merging. The stitched document holds every source event,
time-shifted, with its real pid / tid; one ``process_name`` row per
member; and per trace id seen in more than one process, a flow
(``ph:"s"/"t"/"f"``) threading producer → worker events, plus a
synthesized ``broker_dwell`` span on a "broker" track from produce-end
to the first event in another process. Dumps without a clock anchor
still merge, unshifted, counted in ``stitched.unsynced_processes``.
"""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["stitch", "load_dump"]

# Chrome disallows pid collisions for synthetic tracks; real pids are
# >0, so the synthesized broker-dwell track claims pid 0.
_BROKER_PID = 0


def load_dump(path: str) -> "dict | None":
    """One flight-recorder dump, or None when absent/unreadable (a
    member that died before its exit dump is an expected topology
    outcome, not a stitch error)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return None
    return doc


def _ids_of(event: dict) -> "list[str]":
    """Trace ids an event claims (``trace_id`` scalar and/or the
    bounded ``trace_ids`` list the pipelines record per wave)."""
    args = event.get("args") or {}
    ids = []
    if args.get("trace_id") is not None:
        ids.append(str(args["trace_id"]))
    for t in args.get("trace_ids") or ():
        if t is not None:
            ids.append(str(t))
    return ids


def stitch(dumps: "dict[str, Any]",
           out_path: "str | None" = None) -> dict:
    """Merge named dumps (member name → path or already-loaded doc)
    into one Chrome trace document; optionally write it atomically.
    Returns the stitched doc with a ``stitched`` summary block
    (processes, events, traced ids, cross-pid tracks) the bench leg
    shape-checks."""
    events: "list[dict]" = []
    unsynced = 0
    processes = 0
    # trace id → [(shifted t0 us, shifted t1 us, member, pid, name)]
    by_id: "dict[str, list[tuple]]" = {}
    for member in sorted(dumps):
        doc = dumps[member]
        if isinstance(doc, str):
            doc = load_dump(doc)
        if doc is None:
            continue
        processes += 1
        sync = doc.get("clock_sync") or {}
        shift = 0.0
        if sync.get("monotonic_us") is not None \
                and sync.get("unix_us") is not None:
            shift = float(sync["unix_us"]) - float(sync["monotonic_us"])
        else:
            unsynced += 1
        pid = None
        for ev in doc.get("traceEvents", ()):
            ev = dict(ev)
            ev["ts"] = round(float(ev.get("ts", 0.0)) + shift, 1)
            pid = ev.get("pid", pid)
            events.append(ev)
            for tid in _ids_of(ev):
                by_id.setdefault(tid, []).append(
                    (ev["ts"], ev["ts"] + float(ev.get("dur", 0.0)),
                     member, ev.get("pid"), ev.get("tid", 0),
                     ev.get("name")))
        if pid is not None:
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": member}})

    # flows: one causal thread per trace id that crossed a pid boundary
    cross = 0
    for tid_str, occ in sorted(by_id.items()):
        pids = {o[3] for o in occ}
        if len(pids) < 2:
            continue
        cross += 1
        occ.sort()
        for i, (t0, _t1, _m, pid, tid, _name) in enumerate(occ):
            ph = "s" if i == 0 else ("f" if i == len(occ) - 1 else "t")
            ev = {"name": "probe_path", "cat": "topo", "ph": ph,
                  "id": tid_str, "pid": pid, "tid": tid, "ts": t0}
            if ph == "f":
                ev["bp"] = "e"        # bind to enclosing slice
            events.append(ev)
        # broker dwell: produce-end → first event in ANOTHER process
        first_pid = occ[0][3]
        foreign = [o for o in occ if o[3] != first_pid]
        if foreign:
            t0 = occ[0][1]
            t1 = max(t0, foreign[0][0])
            events.append({
                "name": "broker_dwell", "cat": "topo", "ph": "X",
                "pid": _BROKER_PID, "tid": 1, "ts": round(t0, 1),
                "dur": round(t1 - t0, 1),
                "args": {"trace_id": tid_str}})
    if cross:
        events.append({"name": "process_name", "ph": "M",
                       "pid": _BROKER_PID, "tid": 1,
                       "args": {"name": "broker"}})

    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "stitched": {
            "processes": processes,
            "unsynced_processes": unsynced,
            "events": len(events),
            "traced_ids": len(by_id),
            "cross_pid_tracks": cross,
        },
    }
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)    # a viewer never loads a torn trace
    return doc
