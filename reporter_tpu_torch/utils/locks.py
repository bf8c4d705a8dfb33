"""Named locks and the lockdep runtime: THE spelling for every lock in
reporter_tpu_torch.

Counterpart: reporter_tpu/utils/locks.py. Each lock takes a stable class
name (``"scheduler.stats"``) so its role reads at its construction site,
and the checker keys on that name (Linux-lockdep style: every
``PartialTraceCache`` instance shares one node):

  order edges   each acquisition of B while holding A records the edge
                A→B once; an edge that closes a cycle in the order graph
                is a POTENTIAL DEADLOCK and is recorded as a violation at
                the acquisition that would create it (no actual deadlock
                needs to happen);
  blocking      while armed, the blocking entry points of
                ``BLOCKING_CALLS`` are wrapped; calling one while holding
                any named lock is a violation unless the (lock, call)
                pair is in the committed allowlist
                (``analysis/concurrency_contract.BLOCKING_ALLOW``, dated
                justifications only);
  foreign wait  ``NamedCondition.wait`` while holding any OTHER named
                lock is a blocking violation too (the condvar releases
                only its own lock).

The blocking set: the stdlib five (``time.sleep``, ``os.fsync``,
``subprocess.run``, ``urllib.request.urlopen``,
``socket.create_connection``) and, in place of the JAX package's
``jax.device_put`` / ``jax.block_until_ready``, the calls that make the
host wait for the card: ``torch.cuda.synchronize``,
``torch.cuda.Event.synchronize``, ``torch.cuda.Stream.synchronize``,
``torch.Tensor.cpu`` (a device-to-host copy waits for the stream) and
``torch.Tensor.item`` (a scalar read back, the same wait). Left out:
``Tensor.numpy()`` raises on a CUDA tensor, so the port always reaches it
through ``.cpu()``, which is counted; ``Tensor.to()`` is asynchronous
towards the card and for pinned targets, and its blocking form
(device to pageable host) is spelled ``.cpu()`` throughout the port.
On a CPU tensor ``.cpu()`` and ``.item()`` do not wait, but they are
counted all the same: the code under a lock is the code that runs on the
card.

Arming: OFF by default. ``named_lock`` then returns the plain
``threading`` primitive, so production paths pay nothing (no wrapper
frame, no flag check). ``arm()`` (tests/_torch_support.py does this
before any reporter_tpu_torch module with locks is imported) or
``RTPU_LOCKDEP=1`` makes locks created FROM THEN ON instrumented.

The port's wrappers of the blocking calls carry their own marker
(``__rtt_lockdep_label__``), so they chain with the JAX package's
(``__lockdep_label__``) when a process arms both: each runtime sees the
call under its own locks.

The bookkeeping never blocks: the internal ``_meta`` lock is taken only
AFTER a user lock acquisition returns (or around pure reads) and no user
lock is ever acquired under it. Violations and edges accumulate; the
pytest gate snapshots counts per test and fails the test that grew them.

Seeded-violation tests use a private ``Lockdep`` via
``NamedLock(name, dep=...)`` and ``use(dep)``, so synthetic inversions
never reach the process-global graph the gate compares against the
committed contract.
"""

from __future__ import annotations

import functools
import importlib
import os
import sys
import threading
from typing import Any, Iterable

__all__ = [
    "Lockdep", "NamedLock", "NamedCondition", "named_lock", "named_rlock",
    "named_condition", "arm", "armed", "global_dep", "use",
    "BLOCKING_CALLS", "MARK",
]

# the attribute that marks the port's wrappers (the JAX package's wrappers
# carry __lockdep_label__; a distinct name lets the two chain)
MARK = "__rtt_lockdep_label__"


def _site() -> str:
    """``file.py:line`` of the nearest caller frame outside this module."""
    f = sys._getframe(1)
    try:
        while f is not None and f.f_globals.get("__name__") == __name__:
            f = f.f_back
        if f is None:
            return "?"
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    finally:
        del f


class Lockdep:
    """One order graph and violation ledger. The process-global instance
    backs every ``named_lock``; tests may run a private one."""

    def __init__(self, blocking_allow: "Iterable[tuple[str, str]]" = ()):
        self._meta = threading.Lock()
        self._tls = threading.local()
        self.edges: "dict[tuple[str, str], str]" = {}   # (a, b) → first site
        self.violations: "list[dict]" = []
        self._seen_blocking: "set[tuple]" = set()   # one record per
        #                                             (call, held, site)
        self._seen_order: "set[tuple[str, str]]" = set()   # violating edges
        #                     are never inserted into the graph, so dedupe
        #                     them here or a hot loop floods the ledger
        self.blocking_allow = set(blocking_allow)

    def _stack(self) -> "list[str]":
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> "tuple[str, ...]":
        return tuple(getattr(self._tls, "stack", ()) or ())

    def note_acquire(self, name: str, reentrant: bool) -> None:
        """Record order edges for an acquisition ATTEMPT (before the real
        lock blocks: an inversion is caught even when the schedule
        happens not to deadlock)."""
        st = self._stack()
        if not st:
            return
        if reentrant and name in st:
            return                       # RLock re-entry: no new ordering
        with self._meta:
            for h in st:
                if (h, name) in self.edges:
                    continue
                if h == name or self._reaches(name, h):
                    if (h, name) in self._seen_order:
                        continue
                    self._seen_order.add((h, name))
                    self.violations.append({
                        "kind": "lock-order",
                        "edge": (h, name),
                        "site": _site(),
                        "held": tuple(st),
                        "detail": (f"acquiring {name!r} while holding "
                                   f"{h!r} inverts the recorded order "
                                   f"{name!r}→…→{h!r}"
                                   if h != name else
                                   f"nested acquisition of lock class "
                                   f"{name!r} (self-deadlock shape)"),
                    })
                    # reported, not inserted: a cyclic edge in the graph
                    # would flag innocent later nestings through it
                    continue
                self.edges[(h, name)] = _site()

    def _reaches(self, src: str, dst: str) -> bool:
        """dst reachable from src in the edge graph (caller holds
        _meta)."""
        seen = {src}
        frontier = [src]
        while frontier:
            a = frontier.pop()
            for (x, y) in self.edges:
                if x == a and y not in seen:
                    if y == dst:
                        return True
                    seen.add(y)
                    frontier.append(y)
        return False

    def note_acquired(self, name: str) -> None:
        self._stack().append(name)

    def note_release(self, name: str) -> bool:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):   # the newest entry (RLock
            if st[i] == name:                  # pushes per acquire)
                del st[i]
                return True
        return False

    def note_blocking(self, call: str, exempt: "str | None" = None) -> None:
        st = self._stack()
        if not st:
            return
        offenders = [h for h in st
                     if h != exempt and (h, call) not in self.blocking_allow]
        if not offenders:
            return
        site = _site()
        with self._meta:
            key = (call, tuple(offenders), site)
            if key in self._seen_blocking:
                return
            self._seen_blocking.add(key)
            self.violations.append({
                "kind": "blocking-under-lock",
                "call": call,
                "site": site,
                "held": tuple(offenders),
                "detail": (f"blocking call {call} while holding "
                           f"{offenders!r}: add a dated entry to "
                           "reporter_tpu_torch/analysis/"
                           "concurrency_contract.BLOCKING_ALLOW only if "
                           "the hold is load-bearing"),
            })

    def counts(self) -> "tuple[int, int]":
        with self._meta:
            return len(self.violations), len(self.edges)

    def snapshot(self) -> dict:
        with self._meta:
            return {"edges": dict(self.edges),
                    "violations": list(self.violations)}


_GLOBAL = Lockdep()
_ACTIVE: "list[Lockdep]" = []       # extra instances (seeded tests)
_armed = False
_patched: "set[str]" = set()


def global_dep() -> Lockdep:
    return _GLOBAL


def armed() -> bool:
    if _armed:
        return True
    # env arming (worker subprocesses inherit it); lazy imports: tracing
    # creates named locks, and the contract is import-free
    from reporter_tpu_torch.utils.tracing import env_flag

    if not env_flag(os.environ.get("RTPU_LOCKDEP")):
        return False
    # env arming is programmatic arming: the patches and the allowlist
    from reporter_tpu_torch.analysis.concurrency_contract import \
        BLOCKING_ALLOW

    arm(blocking_allow=set(BLOCKING_ALLOW))
    return True


def arm(blocking_allow: "Iterable[tuple[str, str]] | None" = None) -> Lockdep:
    """Instrument the locks created FROM NOW ON and patch the blocking
    entry points. Idempotent; returns the global instance."""
    global _armed
    _armed = True
    if blocking_allow is not None:
        _GLOBAL.blocking_allow = set(blocking_allow)
    _patch_blocking()
    return _GLOBAL


class use:
    """``with locks.use(dep):`` route blocking-call checks to a private
    Lockdep too (seeded-violation tests). Named locks built with
    ``dep=dep`` already report to it; this covers the patched calls,
    which consult every active instance."""

    def __init__(self, dep: Lockdep):
        self._dep = dep

    def __enter__(self) -> Lockdep:
        _ACTIVE.append(self._dep)
        return self._dep

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self._dep)


# ---------------------------------------------------------------------------
# Instrumented primitives

class NamedLock:
    """Lock / RLock wrapper reporting to a Lockdep instance (acquire,
    release, context manager, locked)."""

    __slots__ = ("name", "_raw", "_dep", "_reentrant")

    def __init__(self, name: str, dep: "Lockdep | None" = None,
                 reentrant: bool = False):
        self.name = name
        self._dep = dep or _GLOBAL
        self._reentrant = reentrant
        self._raw = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._dep.note_acquire(self.name, self._reentrant)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            if not blocking:
                # a try-acquire cannot deadlock, but a success still orders
                self._dep.note_acquire(self.name, self._reentrant)
            self._dep.note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._raw.release()
        self._dep.note_release(self.name)

    def locked(self) -> bool:
        raw = self._raw
        if hasattr(raw, "locked"):          # Lock always; RLock from 3.14
            return raw.locked()
        if raw._is_owned():
            return True
        if raw.acquire(blocking=False):
            raw.release()
            return False
        return True

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<NamedLock {self.name!r} {self._raw!r}>"


class NamedCondition:
    """Condition over a named lock. ``wait`` releases only its OWN lock,
    so waiting while any other named lock is held is flagged as a
    blocking violation (call ``wait:{name}``)."""

    __slots__ = ("name", "_nl", "_cond", "_dep")

    def __init__(self, name: str, lock: "NamedLock | None" = None,
                 dep: "Lockdep | None" = None):
        self.name = name
        self._dep = dep or (lock._dep if lock is not None else _GLOBAL)
        self._nl = lock if lock is not None else NamedLock(name,
                                                           dep=self._dep)
        self._cond = threading.Condition(self._nl._raw)

    def acquire(self, *a, **k) -> bool:
        return self._nl.acquire(*a, **k)

    def release(self) -> None:
        self._nl.release()

    def __enter__(self) -> bool:
        return self._nl.__enter__()

    def __exit__(self, *exc) -> None:
        self._nl.__exit__(*exc)

    def wait(self, timeout: "float | None" = None) -> bool:
        self._dep.note_blocking(f"wait:{self.name}", exempt=self._nl.name)
        held = self._dep.note_release(self._nl.name)   # cond drops the lock
        try:
            return self._cond.wait(timeout)
        finally:
            # `held` guards the misuse path (wait without the lock raises
            # in the stdlib Condition: no phantom entry may survive it)
            if held:
                self._dep.note_acquired(self._nl.name)

    def wait_for(self, predicate, timeout: "float | None" = None):
        self._dep.note_blocking(f"wait:{self.name}", exempt=self._nl.name)
        held = self._dep.note_release(self._nl.name)

        def _instrumented():
            # the stdlib wait_for evaluates the predicate with the lock
            # held again: push the class around each evaluation so an
            # acquisition or blocking call inside it is seen
            self._dep.note_acquired(self._nl.name)
            try:
                return predicate()
            finally:
                self._dep.note_release(self._nl.name)

        try:
            return self._cond.wait_for(_instrumented if held else predicate,
                                       timeout)
        finally:
            if held:
                self._dep.note_acquired(self._nl.name)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# Registry constructors

def named_lock(name: str) -> "Any":
    """A mutex of lock class ``name``. Unarmed: the plain
    ``threading.Lock``."""
    if armed():
        return NamedLock(name)
    return threading.Lock()


def named_rlock(name: str) -> "Any":
    if armed():
        return NamedLock(name, reentrant=True)
    return threading.RLock()


def named_condition(name: str, lock: "Any | None" = None) -> "Any":
    """A condition bound to ``lock`` (a named_lock result) or to a fresh
    lock of class ``name``."""
    if isinstance(lock, NamedLock):
        return NamedCondition(name, lock=lock)
    if armed() and lock is None:
        return NamedCondition(name)
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# Blocking-call patches

# label → (module, owner path inside it, attribute)
BLOCKING_CALLS = {
    "time.sleep": ("time", "", "sleep"),
    "os.fsync": ("os", "", "fsync"),
    "subprocess.run": ("subprocess", "", "run"),
    "urllib.request.urlopen": ("urllib.request", "", "urlopen"),
    "socket.create_connection": ("socket", "", "create_connection"),
    "torch.cuda.synchronize": ("torch.cuda", "", "synchronize"),
    "torch.cuda.Event.synchronize": ("torch.cuda", "Event", "synchronize"),
    "torch.cuda.Stream.synchronize": ("torch.cuda", "Stream", "synchronize"),
    "torch.Tensor.cpu": ("torch", "Tensor", "cpu"),
    "torch.Tensor.item": ("torch", "Tensor", "item"),
}


def _make_wrapper(orig, label: str):
    @functools.wraps(orig)
    def _blocking_guard(*a, **k):
        _GLOBAL.note_blocking(label)
        for dep in _ACTIVE:
            dep.note_blocking(label)
        return orig(*a, **k)

    setattr(_blocking_guard, MARK, label)
    _blocking_guard.__rtt_lockdep_orig__ = orig
    return _blocking_guard


def _patch_blocking() -> None:
    for label, (mod_name, owner_path, attr) in BLOCKING_CALLS.items():
        if label in _patched:
            continue
        owner = importlib.import_module(mod_name)
        for part in filter(None, owner_path.split(".")):
            owner = getattr(owner, part)
        fn = getattr(owner, attr)
        if getattr(fn, MARK, None) != label:
            setattr(owner, attr, _make_wrapper(fn, label))
        _patched.add(label)
