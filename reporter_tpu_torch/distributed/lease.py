"""Partition leasing: elastic membership for the streaming topology.

Counterpart: reporter_tpu/distributed/lease.py (``LeaseTable``,
``plan_rebalance``, ``LeaseRunner``, ``LeaseError``,
``StaleLeaseError``), in the same on-disk formats: ``leases.json`` and
``lease_events.jsonl`` written by either package are operated by the
other, and the same operations leave the same files.

A file-backed lease table beside the broker dir through which workers
acquire time-bounded, epoch-fenced leases over partitions, heartbeat to
renew, and pick up orphaned or reassigned partitions as membership
changes (the consumer-group rebalance a Kafka deployment gets from its
broker; DISTRIBUTED.md "Partition leasing" has the failure model):

  - ONE table directory holds ``leases.json`` (the whole state,
    rewritten atomically tmp+fsync+rename per transaction),
    ``lease_events.jsonl`` (append-only audit log) and ``lock`` (an
    ``fcntl.flock`` file serializing transactions across processes; a
    ``named_lock("lease.table")`` serializes them within one).
  - Every ownership change bumps the partition's **epoch**. Commits
    carry (member, epoch) and are rejected with ``StaleLeaseError``
    unless the committer still holds an unexpired lease at that exact
    epoch: a zombie that lost its lease never moves a floor (fencing).
  - Expiry is STRICT: an expired lease neither renews nor commits. The
    owner observes the loss (``lease_lost``), discards its buffered
    rows, and the next owner resumes at the table's committed floor
    (at-least-once replay). Floors only move through fenced commits, so
    handoff is conservation-exact at offset granularity.
  - ``plan_rebalance`` is a PURE function of (state, now): orphans go
    to the least-loaded live members, surplus beyond the fair share is
    revoked toward under-loaded members with an ``assigned`` hint, and
    the owner hands off gracefully (flush → commit → release). The
    supervisor drives it from its monitor loop; the table applies it.

``lease.table`` holds two edges: the state-file fsync, and the audit
append through the shared ``eventlog.append`` lock (events persist in
the transaction window that produced them, StaleLeaseError included).
Table transactions never call into supervisor or pipeline locks.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from typing import Callable

from reporter_tpu_torch.utils import eventlog, locks

_STATE = "leases.json"
_EVENTS = "lease_events.jsonl"
_LOCK = "lock"

DEFAULT_TTL_S = 5.0


class LeaseError(RuntimeError):
    """Lease-table contract violation (caller bug: floor regression,
    partition out of range, table shape mismatch)."""


class StaleLeaseError(LeaseError):
    """A commit carried a (member, epoch) that no longer holds the
    lease — the fencing rejection. ``partitions`` maps each rejected
    partition to a reason string."""

    def __init__(self, partitions: "dict[int, str]"):
        super().__init__(f"stale lease commit rejected: {partitions}")
        self.partitions = dict(partitions)


class _Txn:
    """One flock-serialized read-modify-write over the table state."""

    __slots__ = ("state", "events", "dirty")

    def __init__(self, state: dict):
        self.state = state
        self.events: list[dict] = []
        self.dirty = False

    def event(self, kind: str, **fields) -> None:
        self.events.append({"event": kind, **fields})


class LeaseTable:
    """File-backed, epoch-fenced partition lease table.

    Safe for concurrent use from many processes (flock) and many
    threads (named lock). All mutation goes through one transaction
    shape: take ``lease.table`` → flock EX → read state → mutate →
    atomic rewrite + append events → unlock.
    """

    def __init__(self, path: str, num_partitions: "int | None" = None,
                 ttl_s: float = DEFAULT_TTL_S,
                 clock: Callable[[], float] = time.time,
                 metrics=None):
        self.path = str(path)
        self.ttl_s = float(ttl_s)
        self.clock = clock
        # optional registry: feeds the lease_reacquire SLO (the
        # observation runs OUTSIDE lease.table — the registry lock must
        # never nest under the table)
        self._metrics = metrics
        if self.ttl_s <= 0:
            raise LeaseError(f"lease ttl must be positive, got {ttl_s}")
        self._lock = locks.named_lock("lease.table")
        os.makedirs(self.path, exist_ok=True)
        self._state_path = os.path.join(self.path, _STATE)
        self._events_path = os.path.join(self.path, _EVENTS)
        self._lock_path = os.path.join(self.path, _LOCK)
        self._events = eventlog.EventLog(self._events_path)
        with self._txn() as t:
            st = t.state
            if not st:
                if num_partitions is None:
                    raise LeaseError(
                        f"no lease table at {self.path!r} and "
                        "num_partitions not given to create one")
                t.state.update({
                    "version": 1,
                    "num_partitions": int(num_partitions),
                    "members": {},
                    "partitions": {
                        str(p): {"owner": None, "epoch": 0,
                                 "expires": 0.0, "committed": 0,
                                 "assigned": None, "revoke": False}
                        for p in range(int(num_partitions))},
                })
                t.dirty = True
                t.event("create", num_partitions=int(num_partitions))
            elif (num_partitions is not None
                  and int(st["num_partitions"]) != int(num_partitions)):
                raise LeaseError(
                    f"lease table at {self.path!r} has "
                    f"{st['num_partitions']} partitions, caller expected "
                    f"{num_partitions}")
        self.num_partitions = int(self._read()["num_partitions"])

    # ---- transaction plumbing -------------------------------------------

    def _read(self) -> dict:
        try:
            with open(self._state_path, encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def _txn(self):
        table = self

        class _Ctx:
            def __enter__(ctx):
                table._lock.acquire()
                ctx._fd = os.open(table._lock_path,
                                  os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(ctx._fd, fcntl.LOCK_EX)
                ctx._t = _Txn(table._read())
                return ctx._t

            def __exit__(ctx, exc_type, exc, tb):
                try:
                    if exc_type is None or isinstance(exc, StaleLeaseError):
                        # fencing rejections still persist their audit
                        # events + any commits applied before the raise
                        table._write(ctx._t)
                finally:
                    fcntl.flock(ctx._fd, fcntl.LOCK_UN)
                    os.close(ctx._fd)
                    table._lock.release()
                return False

        return _Ctx()

    def _write(self, t: _Txn) -> None:
        if t.dirty:
            tmp = self._state_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(t.state, f)
                f.flush()
                # Load-bearing: the lease file is the cross-process
                # ownership truth — a torn or reordered write could
                # hand one partition to two workers
                # (BLOCKING_ALLOW: lease.table, os.fsync).
                os.fsync(f.fileno())
            os.replace(tmp, self._state_path)
        if t.events:
            # the shared EventLog spelling; runs while lease.table
            # is held — the contract-dated (lease.table, eventlog.append)
            # edge: audit events must land in the same transaction
            # window that produced them (incl. through StaleLeaseError)
            now = self.clock()
            self._events.extend({"t": now, **e} for e in t.events)

    def _ent(self, t: _Txn, partition: int) -> dict:
        ent = t.state["partitions"].get(str(int(partition)))
        if ent is None:
            raise LeaseError(f"partition {partition} out of range "
                             f"0..{t.state['num_partitions'] - 1}")
        return ent

    @staticmethod
    def _expired(ent: dict, now: float) -> bool:
        return ent["owner"] is not None and now > float(ent["expires"])

    # ---- the lease protocol ---------------------------------------------

    def acquire(self, member: str, partition: int,
                ttl_s: "float | None" = None) -> "int | None":
        """Try to take ``partition``. Returns the lease epoch on success
        (ownership change bumps it; re-acquiring one's own live lease
        renews and keeps it), None if another member holds it or it is
        assigned elsewhere by the rebalancer."""
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        reacquire_gap: "float | None" = None
        with self._txn() as t:
            ent = self._ent(t, partition)
            now = self.clock()
            if ent["owner"] == member and not self._expired(ent, now):
                ent["expires"] = now + ttl
                t.dirty = True
                return int(ent["epoch"])
            if ent["owner"] is not None and not self._expired(ent, now):
                return None
            hint = ent["assigned"]
            if hint is not None and hint != member:
                return None      # rebalancer reserved it for someone else
            prev = ent["owner"]
            if prev is not None:
                t.event("expired", partition=int(partition), member=prev,
                        epoch=int(ent["epoch"]))
                # expiry→takeover gap: how long the partition sat
                # unserved — the lease_reacquire SLO's observation
                reacquire_gap = max(0.0, now - float(ent["expires"]))
            ent["epoch"] = int(ent["epoch"]) + 1
            ent["owner"] = member
            ent["expires"] = now + ttl
            ent["revoke"] = False
            ent["assigned"] = None
            t.dirty = True
            t.event("acquire", partition=int(partition), member=member,
                    epoch=int(ent["epoch"]),
                    committed=int(ent["committed"]),
                    takeover_from=prev)
            epoch = int(ent["epoch"])
        # observed AFTER the transaction exits: metrics.registry must
        # never nest under lease.table
        if reacquire_gap is not None and self._metrics is not None:
            self._metrics.observe("lease_reacquire_seconds",
                                  reacquire_gap)
        return epoch

    def renew(self, member: str, ttl_s: "float | None" = None) -> dict:
        """Heartbeat + one consistent view for ``member``: renew every
        live lease it holds, observe losses (strict expiry — an expired
        lease is cleared, never resurrected), and report what the
        rebalancer wants: ``revoke`` (hand off gracefully), ``assigned``
        (reserved for this member), ``orphans`` (free for anyone)."""
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        with self._txn() as t:
            now = self.clock()
            t.state["members"][member] = {"heartbeat": now}
            t.dirty = True
            owned: dict[int, int] = {}
            revoke: list[int] = []
            assigned: list[int] = []
            orphans: list[int] = []
            lost: list[int] = []
            for key, ent in sorted(t.state["partitions"].items(),
                                   key=lambda kv: int(kv[0])):
                p = int(key)
                if ent["owner"] == member:
                    if now > float(ent["expires"]):
                        # strict expiry: the lease is gone; clear the
                        # owner so the next acquire is a clean takeover
                        ent["owner"] = None
                        ent["revoke"] = False
                        lost.append(p)
                        t.event("lease_lost", partition=p, member=member,
                                epoch=int(ent["epoch"]))
                        continue
                    ent["expires"] = now + ttl
                    owned[p] = int(ent["epoch"])
                    if ent["revoke"]:
                        revoke.append(p)
                elif ent["owner"] is None or now > float(ent["expires"]):
                    if ent["assigned"] == member:
                        assigned.append(p)
                    elif ent["assigned"] is None:
                        orphans.append(p)
            return {"owned": owned, "revoke": revoke,
                    "assigned": assigned, "orphans": orphans,
                    "lost": lost}

    def commit_many(self, member: str,
                    updates: "dict[int, tuple[int, int]]") -> None:
        """Fenced floor movement: ``updates[p] = (epoch, offset)``.
        Every passing update applies (monotonic: equal floors are
        no-ops, regressions are a caller bug and raise ``LeaseError``);
        if ANY update fails the fence, ``StaleLeaseError`` is raised
        after the passing ones are applied, naming the rejected
        partitions."""
        if not updates:
            return
        rejected: dict[int, str] = {}
        with self._txn() as t:
            now = self.clock()
            for p, (epoch, offset) in sorted(updates.items()):
                ent = self._ent(t, p)
                if (ent["owner"] != member or int(ent["epoch"]) != int(epoch)
                        or now > float(ent["expires"])):
                    why = ("expired" if ent["owner"] == member
                           else f"owner={ent['owner']!r} "
                                f"epoch={ent['epoch']}")
                    rejected[int(p)] = why
                    t.event("commit_rejected", partition=int(p),
                            member=member, epoch=int(epoch), reason=why)
                    continue
                cur = int(ent["committed"])
                off = int(offset)
                if off < cur:
                    raise LeaseError(
                        f"commit regression on partition {p}: "
                        f"{off} < floor {cur} (member {member!r})")
                if off == cur:
                    continue
                ent["committed"] = off
                t.dirty = True
                t.event("commit", partition=int(p), member=member,
                        epoch=int(epoch), floor_from=cur, floor_to=off)
            if rejected:
                raise StaleLeaseError(rejected)

    def commit(self, member: str, partition: int, epoch: int,
               offset: int) -> None:
        self.commit_many(member, {int(partition): (int(epoch),
                                                   int(offset))})

    def release(self, member: str, partition: int, epoch: int,
                floor: "int | None" = None) -> bool:
        """Graceful handoff: optionally push a final fenced floor, then
        free the partition (keeping the epoch — the next owner bumps
        it). Returns False (with an audit event) if the lease was
        already lost."""
        with self._txn() as t:
            ent = self._ent(t, partition)
            now = self.clock()
            if (ent["owner"] != member or int(ent["epoch"]) != int(epoch)
                    or now > float(ent["expires"])):
                t.event("release_noop", partition=int(partition),
                        member=member, epoch=int(epoch))
                return False
            if floor is not None and int(floor) > int(ent["committed"]):
                t.event("commit", partition=int(partition), member=member,
                        epoch=int(epoch),
                        floor_from=int(ent["committed"]),
                        floor_to=int(floor))
                ent["committed"] = int(floor)
            ent["owner"] = None
            ent["revoke"] = False
            t.dirty = True
            t.event("release", partition=int(partition), member=member,
                    epoch=int(epoch))
            return True

    def apply_plan(self, plan: dict) -> None:
        """Apply a ``plan_rebalance`` output: ``assign`` reserves
        orphans ({partition: member}), ``revoke`` flags owned
        partitions for graceful handoff with a destination hint
        ({partition: member}), ``clear`` drops stale hints."""
        if not (plan.get("assign") or plan.get("revoke")
                or plan.get("clear")):
            return
        with self._txn() as t:
            for p, m in sorted(plan.get("assign", {}).items()):
                ent = self._ent(t, p)
                if ent["assigned"] != m:
                    ent["assigned"] = m
                    t.dirty = True
                    t.event("assign", partition=int(p), member=m)
            for p, m in sorted(plan.get("revoke", {}).items()):
                ent = self._ent(t, p)
                if ent["owner"] is not None and not ent["revoke"]:
                    ent["revoke"] = True
                    ent["assigned"] = m
                    t.dirty = True
                    t.event("revoke_requested", partition=int(p),
                            member=ent["owner"], to=m)
            for p in plan.get("clear", ()):
                if p in plan.get("assign", {}):
                    continue             # fresh assignment wins the slot
                ent = self._ent(t, p)
                if ent["assigned"] is not None and ent["owner"] is None:
                    ent["assigned"] = None
                    t.dirty = True

    # ---- read surfaces ---------------------------------------------------

    def state(self) -> dict:
        """A point-in-time copy of the whole table state."""
        with self._txn() as t:
            return json.loads(json.dumps(t.state))

    def committed(self, partition: int) -> int:
        with self._txn() as t:
            return int(self._ent(t, partition)["committed"])

    def floors(self) -> "list[int]":
        """Committed floors, indexed by partition."""
        with self._txn() as t:
            parts = t.state["partitions"]
            return [int(parts[str(p)]["committed"])
                    for p in range(int(t.state["num_partitions"]))]

    def events(self) -> "list[dict]":
        return self._events.read()


def plan_rebalance(state: dict, now: float, member_ttl_s: float,
                   running: "set[str] | None" = None) -> dict:
    """Pure rebalance planner over a ``LeaseTable.state()`` snapshot.

    Live members = heartbeat within ``member_ttl_s``. ``running``
    narrows that with out-of-band knowledge (the supervisor's process
    table): a member the caller KNOWS is dead must not receive
    assignments during its heartbeat grace window — a stale hint to a
    corpse pins the partition against every other acquirer until a
    later pass clears it (measured: +8 s on the orphan-reacquire path).
    Orphans (unowned or lease-expired, no standing hint) go to the
    least-loaded live member; when the spread between the most- and
    least-loaded members is ≥ 2 partitions, one surplus partition is
    revoked toward the least-loaded (repeat until fair). Revoke-pending
    partitions count toward their DESTINATION so a slow handoff is
    never double-revoked. Deterministic: ties break on member name,
    partitions scan in order.
    """
    members = state.get("members", {})
    live = sorted(m for m, md in members.items()
                  if now - float(md.get("heartbeat", 0.0)) <= member_ttl_s
                  and (running is None or m in running))
    plan: dict = {"assign": {}, "revoke": {}, "clear": []}
    if not live:
        return plan
    load = {m: 0 for m in live}
    orphans: list[int] = []
    owner_of: dict[int, str] = {}
    revocable: dict[str, list[int]] = {m: [] for m in live}
    for key, ent in sorted(state["partitions"].items(),
                           key=lambda kv: int(kv[0])):
        p = int(key)
        hint = ent["assigned"] if ent["assigned"] in load else None
        alive = ent["owner"] is not None and now <= float(ent["expires"])
        if alive:
            owner_of[p] = ent["owner"]
            if ent["revoke"] and hint is not None:
                load[hint] += 1          # handoff in flight: count at dest
            elif ent["owner"] in load:
                load[ent["owner"]] += 1
                if not ent["revoke"]:
                    revocable[ent["owner"]].append(p)
            # owner alive lease-wise but heartbeat-stale: leave it —
            # expiry frees it without a second mechanism
        elif hint is not None:
            load[hint] += 1              # standing assignment: honor it
        else:
            if ent["assigned"] is not None:
                plan["clear"].append(p)  # hint to a dead member: drop it
            orphans.append(p)
    for p in orphans:
        m = min(live, key=lambda x: (load[x], x))
        plan["assign"][p] = m
        load[m] += 1
    while True:
        hi = max(live, key=lambda x: (load[x], x))
        lo = min(live, key=lambda x: (load[x], x))
        if load[hi] - load[lo] < 2 or not revocable[hi]:
            break
        p = revocable[hi].pop()
        plan["revoke"][p] = lo
        load[hi] -= 1
        load[lo] += 1
    return plan


class LeaseRunner:
    """Worker-side lease protocol driver for one StreamPipeline.

    ``sync()`` (throttled to ~ttl/4) renews, observes losses (buffered
    rows for a lost partition are DISCARDED — the next owner replays
    them from the table floor; keeping them would double-publish),
    hands off revoked partitions gracefully (flush → fenced final
    commit → release), and adopts assigned/orphaned partitions at
    their committed floors. ``push_commits()`` forwards the pipeline's
    floor movement through the fence after every step.
    """

    def __init__(self, table: LeaseTable, member: str, pipeline,
                 poll_s: "float | None" = None):
        self.table = table
        self.member = member
        self.pipe = pipeline
        self.poll_s = (max(0.05, table.ttl_s / 4.0)
                       if poll_s is None else float(poll_s))
        self._next_sync = 0.0
        self.epochs: dict[int, int] = {}
        self._pushed: dict[int, int] = {}
        self.stats = {"acquired": 0, "lost": 0, "revoked": 0,
                      "stale_commits": 0, "discarded_points": 0}

    def sync(self, force: bool = False) -> bool:
        """One membership round-trip; returns True if the owned set
        changed."""
        now = time.monotonic()
        if not force and now < self._next_sync:
            return False
        self._next_sync = now + self.poll_s
        view = self.table.renew(self.member)
        changed = False
        for p in [p for p in self.epochs if p not in view["owned"]]:
            self._drop(p)                     # lease lost: discard rows
            self.stats["lost"] += 1
            changed = True
        for p in view["revoke"]:
            if p in self.epochs:
                self._handoff(p)
                changed = True
        for p in view["assigned"] + view["orphans"]:
            epoch = self.table.acquire(self.member, p)
            if epoch is None:
                continue                      # raced another member
            self.pipe.adopt_partition(p, self.table.committed(p))
            self.epochs[p] = epoch
            self._pushed[p] = self.pipe.committed[p]
            self.stats["acquired"] += 1
            changed = True
        return changed

    def push_commits(self) -> None:
        """Forward pipeline floor movement through the epoch fence."""
        updates = {p: (e, int(self.pipe.committed[p]))
                   for p, e in self.epochs.items()
                   if int(self.pipe.committed[p]) > self._pushed[p]}
        if not updates:
            return
        try:
            self.table.commit_many(self.member, updates)
            bad: dict[int, str] = {}
        except StaleLeaseError as exc:
            bad = exc.partitions
        for p in updates:
            if p in bad:
                self._drop(p)
                self.stats["stale_commits"] += 1
            else:
                self._pushed[p] = updates[p][1]

    def _handoff(self, p: int) -> None:
        """Graceful revoke: flush the partition's rows through the
        matcher, push the final floor, release."""
        self.pipe.release_partition(p, flush=True)
        self.table.release(self.member, p, self.epochs[p],
                           floor=int(self.pipe.committed[p]))
        self.epochs.pop(p, None)
        self._pushed.pop(p, None)
        self.stats["revoked"] += 1

    def _drop(self, p: int) -> None:
        """Lost lease: drop the partition WITHOUT flushing — its
        unflushed rows replay at the new owner from the table floor;
        publishing them here would duplicate reports."""
        self.stats["discarded_points"] += self.pipe.release_partition(
            p, flush=False)
        self.epochs.pop(p, None)
        self._pushed.pop(p, None)

    def shutdown(self) -> None:
        """Graceful exit: hand off everything still held."""
        for p in sorted(self.epochs):
            self._handoff(p)

    def lag(self) -> int:
        """GLOBAL backlog: queue end offsets minus table floors over ALL
        partitions — the lease-mode drain condition (a worker owning
        nothing must not exit while other partitions still have
        uncommitted records that could rebalance onto it)."""
        floors = self.table.floors()
        return sum(max(0, self.pipe.queue.end_offset(p) - floors[p])
                   for p in range(self.table.num_partitions))
