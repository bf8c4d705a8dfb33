"""The port's committed lockdep contract: extend with a DATED
justification only; never delete an entry to silence a failure without
understanding the ordering it pinned.

Counterpart: reporter_tpu/analysis/concurrency_contract.py. The port
keeps its own copy (it imports nothing of the JAX package), seeded from
the JAX entries whose lock classes the port has: the port's modules are
copies of the JAX ones, so the same code nests the same locks. Entries
dated 2026-10-17 are the port's own: nestings the armed port suite
(tests/test_torch_*.py) recorded, and the blocking calls of the port's
device half.

``LOCK_ORDER_EDGES`` is the set of legal lock-class acquisition-order
edges (A, B): "a thread may acquire B while holding A". The runtime
(reporter_tpu_torch/utils/locks.py, armed by tests/_torch_support.py)
records every observed edge; the per-test gate fails on

  - any edge NOT in this set (a new nesting: add it here with a
    justification, or restructure the code so the nesting disappears);
  - any edge that would close a CYCLE in the graph (potential deadlock:
    never allowlist these; fix the order).

``BLOCKING_ALLOW`` is the set of (lock class, blocking call) pairs that
are deliberately held across a blocking call. The hold must be
load-bearing for correctness and the call bounded.

How to read a failure: the gate prints the violation dicts: ``kind``
(lock-order | blocking-under-lock), the offending ``edge`` or ``call``,
the ``held`` stack, and ``site`` (file:line of the acquisition or the
call). The fix is almost always to shrink the inner critical section, or
to snapshot state and release before calling out.
"""

from __future__ import annotations

__all__ = ["LOCK_ORDER_EDGES", "BLOCKING_ALLOW", "validate"]

LOCK_ORDER_EDGES: "dict[tuple[str, str], str]" = {
    # (the entries down to the port's own section are the JAX
    # contract's, for the same code in the port)
    # ---- scheduler (service/scheduler.py) -------------------------------
    ("scheduler.cv", "scheduler.stats"): "2026-08-04 batch close updates "
        "deferral/hist counters while still deciding under the condvar; "
        "stats is a leaf lock held for a dict write",
    ("scheduler.cv", "metrics.registry"): "2026-08-04 admission/inflight "
        "gauges published at the decision point under the condvar; the "
        "registry lock is a leaf (O(1) dict write, never calls out)",
    ("scheduler.cv", "readahead.tasks"): "2026-08-06 a closing batch "
        "submits its prepare-ahead ticket under the condvar — the worker "
        "may pop the job immediately, so the ticket must exist before "
        "the work-queue put (r22 pipelined prepare); the read-ahead lock "
        "is a LEAF by construction (guards the task deque only; "
        "submitted callables run strictly outside it — "
        "utils/readahead.py docstring)",
    # ---- metrics as a leaf under component locks -------------------------
    ("scheduler.stats", "metrics.registry"): "2026-08-04 padding stats + "
        "occupancy gauge in one section (pad_traces); leaf write",
    ("fleet.ledger", "metrics.registry"): "2026-08-04 residency "
        "hit/miss/eviction counters and occupancy gauges publish at the "
        "paging event under the ledger (O(1) per event by design, "
        "round 11); leaf write",
    ("matcher.fallback", "metrics.registry"): "2026-08-04 the oracle "
        "fallback matcher counts its own traces while serialized on the "
        "fallback lock; leaf write",
    ("app.combine", "metrics.registry"): "2026-08-04 combine-mode leader "
        "observes request metrics while holding the one-batch-in-flight "
        "lock (legacy A/B path, kept by round-7 decision); leaf write",
    # ---- legacy combine leader (service/app.py) --------------------------
    ("app.combine", "app.pending"): "2026-08-04 the leader drains the "
        "pending queue it owns; pending is a leaf list-swap lock",
    ("app.combine", "app.stats"): "2026-08-04 leader bumps batch counters "
        "after a drain round; leaf write",
    ("app.combine", "cache.entries"): "2026-08-04 combine-mode "
        "_process_validated merges/retains per-uuid tails under the "
        "leader lock; cache is a leaf (TTL dict ops only)",
    ("app.combine", "publisher.counters"): "2026-08-04 combine-mode "
        "publish counts outcomes under the leader lock; leaf write",
    ("app.combine", "faults.plan"): "2026-08-04 combine-mode publish "
        "consults the active fault plan (a counter increment) under the "
        "leader lock; leaf write",
    ("app.combine", "faults.registry"): "2026-08-04 faults.active()'s "
        "lazy one-shot env parse takes the registry lock on first "
        "consultation, which can land under the combine leader; leaf",
    ("app.combine", "tracer.dump"): "2026-08-04 combine-mode publish "
        "failure can dead-letter and post-mortem under the leader lock "
        "(legacy path); dump lock is only contended by other dumps",
    ("app.combine", "publisher.spool"): "2026-08-04 combine-mode "
        "dead-letter append under the leader lock (legacy path); the "
        "spool append is a bounded local write",
    ("app.combine", "watchdog.ledger"): "2026-08-04 combine-mode "
        "dispatch checks the watchdog breaker (tripped/abandoned "
        "bookkeeping) under the leader lock; the ledger lock is held "
        "for nanoseconds by contract (utils/watchdog.py docstring)",
    # ---- fleet router (fleet/router.py) ----------------------------------
    ("fleet_router.app_build", "fleet_router.apps"): "2026-08-04 app() "
        "re-checks and publishes the built app in the dict under the "
        "per-metro build lock (double-checked construction); apps is a "
        "leaf dict guard",
    ("fleet_router.app_build", "fleet.ledger"): "2026-08-04 building a "
        "metro's app promotes it through residency under the per-metro "
        "build lock — the lock is PER METRO precisely so this nesting "
        "stalls only that metro's first touch (round-11 decision)",
    ("fleet_router.app_build", "metrics.registry"): "2026-08-04 "
        "promotion under the build lock publishes paging gauges; leaf",
    # ---- tracing ---------------------------------------------------------
    ("tracer.dump", "tracer.tid"): "2026-08-04 dump() resolves thread ids "
        "while holding the dump lock — tid got its OWN lock for exactly "
        "this nesting (round 10); tid is a leaf",
    # ---- link health (round 15) ------------------------------------------
    ("linkhealth.state", "metrics.registry"): "2026-08-04 every recorded "
        "link sample publishes its gauges to the attached registries in "
        "the same section (the ring append and the gauge write must see "
        "one consistent sample); the registry lock is a leaf O(1) dict "
        "write. Probes themselves NEVER run under linkhealth.state — "
        "the sampler bounds them with the shared watchdog first and "
        "records the finished result",
    ("fleet_router.app_build", "linkhealth.registry"): "2026-08-04 a "
        "metro app's first-touch construction (under its per-metro "
        "build lock, the round-11 design) attaches its registry to the "
        "process link sampler; the registry lock guards one lazy "
        "construction + a module pointer read, never calls out",
    ("fleet_router.app_build", "linkhealth.state"): "2026-08-04 same "
        "first-touch construction: attach/start take the sampler state "
        "lock for a list append + gauge replay; leaf section (probing "
        "happens on the sampler's own daemon thread, not here)",
    ("app.combine", "linkhealth.registry"): "2026-08-04 the legacy "
        "combine leader holds its lock through the whole dispatch (kept "
        "r7 A/B design), so a dispatch TIMEOUT's dead-link note "
        "(linkhealth.note_dispatch_timeout) lands under it; the "
        "registry lock guards one module-pointer read",
    ("app.combine", "linkhealth.state"): "2026-08-04 same path: the "
        "dead-link sample records under the sampler state lock — a "
        "ring append + leaf gauge writes, the same shape as the "
        "existing app.combine -> metrics.registry edge",
    # ---- quality telemetry (round 18) ------------------------------------
    ("app.combine", "quality.monitor"): "2026-08-04 the legacy combine "
        "leader holds its lock through match_many (kept r7 A/B design), "
        "so the harvest's quality-window append lands under it; the "
        "monitor lock is a LEAF by contract (guards the window deque "
        "only — publication/fault-plan/post-mortem all run outside it)",
    ("app.combine", "quality.audit"): "2026-08-04 same combine-leader "
        "path: the shadow-audit sampling decision (one counted seeded "
        "draw + a bounded enqueue) lands under the leader lock; the "
        "audit lock is a leaf — the oracle runs on the auditor's own "
        "daemon thread, never here",
    ("app.combine", "quality.registry"): "2026-08-04 same path: "
        "quality_audit.auditor()'s lazy one-shot construction guard "
        "(the faults.registry shape, already edged above)",
    # (NOTE r18: oracle instances — the watchdog fallback and the
    # shadow-audit oracle — run with their quality telemetry DISABLED,
    # so no matcher.fallback -> quality/faults/tracer nesting exists;
    # the shadow audit also runs a DEDICATED oracle instance and never
    # takes matcher.fallback at all)
    # ---- topology supervisor (round 19) ----------------------------------
    # supervisor.members / supervisor.sink are LEAF locks BY
    # CONSTRUCTION (distributed/supervisor.py docstring): spawning
    # (subprocess.Popen is a patched blocking entry point),
    # post-mortems, gauge publication, and snapshot merging all run
    # outside them, so the topology layer contributes zero order edges
    # and zero blocking-allow entries. (The r19 supervisor.events lock
    # was absorbed into the shared eventlog.append class in round 24 —
    # still a leaf.) A future edge from any of them is a design change
    # — justify it here with a date, don't just add it.
    # ---- event logs (round 24) -------------------------------------------
    ("lease.table", "eventlog.append"): "2026-08-07 lease audit events "
        "persist inside the table transaction window (through "
        "StaleLeaseError — a fencing rejection that vanished from the "
        "log would be undebuggable, round 23), and round 24 moved the "
        "append behind the shared utils/eventlog.py writer; "
        "eventlog.append is a LEAF by construction (append+flush of "
        "prebuilt lines, no fsync, never calls out)",
    # obs.slo (round 24) is a LEAF by construction: it guards only the
    # snapshot ring, throttle stamp and alert state — the export pull,
    # gauge publication, ledger append and tracer all run outside it
    # (the quality.monitor shape).
    # ---- streaming brokers ----------------------------------------------
    ("broker.partitions", "faults.plan"): "2026-08-04 durable append "
        "consults the broker fault site inside the partition lock so an "
        "injected torn write lands exactly where a real one would; the "
        "plan lock is a leaf counter",
    ("broker.partitions", "faults.registry"): "2026-08-06 "
        "faults.active()'s lazy one-shot env parse takes the registry "
        "lock on first consultation, which can land under a durable "
        "partition lock when a broker fault site is the process's first "
        "consultation (the backfill engine's reader thread reaches one "
        "before any matcher site); leaf — the app.combine edge's shape",
    # ---- publisher -------------------------------------------------------
    ("publisher.spool", "publisher.counters"): "2026-08-04 replay "
        "rewrites the spool prefix and reconciles pending/replayed "
        "counts in one section; counters is a leaf",
    # ---- the port's own (2026-10-17) -----------------------------------
    # matcher.counters is the port's lock of SegmentMatcher.stage_seconds
    # and point_counts (the JAX matcher keeps them in jit-free host code
    # without a lock); a LEAF by construction: float adds and int adds,
    # never calls out
    ("app.combine", "matcher.counters"): "2026-10-17 the legacy combine "
        "leader holds its lock through match_many (the kept r7 A/B "
        "design, the app.combine -> metrics.registry shape), so the "
        "matcher's stage seconds add under it; leaf write",
    ("matcher.fallback", "matcher.counters"): "2026-10-17 the oracle "
        "fallback matcher adds its stage seconds while serialized on the "
        "fallback lock (the matcher.fallback -> metrics.registry shape); "
        "leaf write",
}


BLOCKING_ALLOW: "dict[tuple[str, str], str]" = {
    ("publisher.spool", "os.fsync"): "2026-08-04 dead-letter prefix "
        "rewrite must exclude concurrent appends or a just-spooled batch "
        "is lost in the os.replace; the spool is bounded and the POSTs "
        "(the unbounded leg) run outside the lock (round-9 hardening)",
    ("broker.partitions", "os.fsync"): "2026-08-04 durable broker "
        "appends fsync under the partition lock so on-disk batch order "
        "always matches offset order (round-6 discipline); per-append "
        "fsync is the opted-in durability cost",
    ("app.combine", "urllib.request.urlopen"): "2026-08-04 the legacy "
        "combine leader holds its lock through the full publish round "
        "trip BY DESIGN (round-7 A/B baseline); the scheduler path "
        "exists because of this: do not extend this entry to new code",
    ("app.combine", "time.sleep"): "2026-08-04 same combine-leader "
        "design: publish retry backoff sleeps ride the leader lock in "
        "the legacy path only",
    ("fleet_router.app_build", "wait:fleet.ledger"): "2026-08-04 a "
        "first-touch app build can park on the fleet condvar (another "
        "thread mid-promotion of the same metro, or a capacity wait) "
        "while holding the per-metro build lock: only THIS metro's "
        "traffic waits, and the wait is bounded by promote_wait_s",
    ("lease.table", "os.fsync"): "2026-08-07 the lease state file is "
        "the cross-process ownership truth: a transaction's tmp-file "
        "fsync MUST complete under the table lock before the os.replace, "
        "or a torn or reordered write could hand one partition to two "
        "workers; one small JSON doc, and the lock is otherwise a leaf",
    # ---- the port's own (2026-10-17) -----------------------------------
    ("app.combine", "torch.Tensor.cpu"): "2026-10-17 the port's twin of "
        "the JAX entries (app.combine, jax.block_until_ready / "
        "jax.device_put): the combine leader holds its lock through the "
        "whole dispatch BY DESIGN (the kept r7 A/B arm), so the harvest's "
        "wire copy to the host (matcher/api.py, parallel/dp_e2e.py "
        "ShardedWire.cpu) waits under it; the scheduler is the fix, do "
        "not extend this entry to new code",
}


def validate() -> None:
    """Contract self-checks (test-asserted): the edge set is acyclic (a
    cyclic contract would bless a deadlock) and every entry carries a
    dated justification."""
    import re

    dated = re.compile(r"20\d\d-\d\d-\d\d")
    for table in (LOCK_ORDER_EDGES, BLOCKING_ALLOW):
        for key, why in table.items():
            if not dated.search(why or ""):
                raise AssertionError(
                    f"{key}: justification must carry a date: {why!r}")
    adj: "dict[str, list[str]]" = {}
    for (a, b) in LOCK_ORDER_EDGES:
        adj.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in set(adj) | {b for v in adj.values()
                                           for b in v}}

    def dfs(n: str, path: "list[str]") -> None:
        color[n] = GRAY
        for m in adj.get(n, ()):
            if color[m] == GRAY:
                raise AssertionError(
                    f"the contract's lock-order graph has a cycle through "
                    f"{path + [n, m]}: a committed deadlock; fix the "
                    "order instead of extending the graph")
            if color[m] == WHITE:
                dfs(m, path + [n])
        color[n] = BLACK

    for n in list(color):
        if color[n] == WHITE:
            dfs(n, [])
