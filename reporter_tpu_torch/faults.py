"""Deterministic fault injection — one mechanism for tests and runs.

Counterpart: reporter_tpu/faults.py (``FaultPlan``, ``install``, ``use``,
``fire``, ``check``, ``backoff_schedule``), with the same spec grammar
and the same seeded per-site schedule, so one ``RTPU_FAULTS`` string
replays the same faults in either package. A plan is installed
programmatically (``with faults.use(plan): ...``) or by environment
(``RTPU_FAULTS="publish:fail@10-40"``, seed ``RTPU_FAULT_SEED``).

Injection sites of this package:

  publish     datastore transport (service/datastore.py): an injected
              fault raises ``InjectedFault`` (an OSError), so the
              publisher's retry, backoff and dead-letter spool handle it
              exactly like a network outage
  checkpoint  streaming/state.save_checkpoint: fires after the tmp file
              is written and before the atomic rename, the simulated
              mid-checkpoint death the atomic write must survive
  broker      durable broker batch append (streaming/durable_columnar.py):
              ``torn`` writes half the frame and then dies, ``crash`` and
              ``fail`` die before the write; both raise InjectedCrash
  dispatch    device dispatch (matcher/api.py): fires inside the
              watchdog's guarded body, so ``hang`` stalls exactly where a
              wedged dispatch would, which is what the dispatch watchdog
              exists to bound
  quality     drift-sentinel evaluation (quality/monitor.py): a rule
              covering the evaluation's call index forces the window to
              read DRIFTED
  backfill    open-loop wave completion (backfill/engine.py): fires once
              per aggregated wave, so ``backfill:crash@N`` kills a spool
              replay between a harvest and its checkpoint

Rules are windows over a per-site CALL COUNTER (0-based); the optional
``p`` is drawn from a per-site ``random.Random(seed)`` stream. Spec
grammar (';'-separated):

    site:kind[(seconds)]@lo[-hi][~p]

    publish:fail@10-40          calls 10..39 raise InjectedFault
    publish:fail@0-~0.25        every call fails w.p. 0.25 (seeded)
    checkpoint:crash@1          the 2nd checkpoint dies before rename
    broker:torn@3               the 4th batch append tears mid-frame
    quality:fail@3              the 4th evaluation reads drifted
    dispatch:hang(1.5)@1        the 2nd dispatch stalls 1.5 s
    backfill:crash@2            the 3rd completed wave dies

``hi`` omitted ⇒ ``lo+1``; ``hi`` empty (``@5-``) ⇒ open-ended. Parsing
is strict: a malformed spec, an unknown site, an empty window, a zero
probability or a duration on a non-hang kind raises ``ValueError`` at
plan construction.
"""

from __future__ import annotations

import os
import random
import re
import time
from dataclasses import dataclass, field

from reporter_tpu_torch.utils import locks

# the injection sites, in the JAX package's order (fleet_promote fires on
# the fleet's transfer thread, fleet/residency.py)
SITES = ("publish", "checkpoint", "broker", "dispatch", "fleet_promote",
         "quality", "backfill")
KINDS = ("fail", "crash", "hang", "torn")


class InjectedFault(OSError):
    """Transport-shaped injected failure (publish site): callers' real
    error paths — retry, backoff, dead-letter — handle it unchanged."""


class InjectedCrash(RuntimeError):
    """Simulated process death mid-operation (checkpoint/broker sites).
    Tests catch it where a real crash would have killed the process."""


@dataclass(frozen=True)
class FaultRule:
    kind: str                 # fail | crash | hang | torn
    lo: int = 0               # fire on call indices lo <= i < hi
    hi: float = 1             # float so inf can mean open-ended
    seconds: float = 0.0      # hang duration
    p: float = 1.0            # fire probability within the window

    def covers(self, i: int) -> bool:
        return self.lo <= i < self.hi

    def clause(self, site: str) -> str:
        """Canonical spec-grammar text for this rule (error messages
        name the bad clause in the author's own notation)."""
        secs = f"({self.seconds:g})" if self.seconds else ""
        if self.hi == float("inf"):
            span = f"{self.lo}-"
        elif self.hi == self.lo + 1:
            span = f"{self.lo}"
        else:
            span = f"{self.lo}-{int(self.hi)}"
        # p == 1.0 exactly is the grammar default and elides; an
        # out-of-range p must still render so validation errors can
        # name the offending clause verbatim
        prob = "" if self.p == 1.0 else f"~{self.p:g}"
        return f"{site}:{self.kind}{secs}@{span}{prob}"


_RULE_RE = re.compile(
    r"^(?P<site>\w+):(?P<kind>\w+)"
    r"(?:\((?P<seconds>[0-9.]+)\))?"
    r"@(?P<lo>\d+)(?P<span>-(?P<hi>\d*))?"
    r"(?:~(?P<p>[0-9.]+))?$")


@dataclass
class FaultPlan:
    """Seeded, counted fault schedule over the injection sites."""

    rules: "dict[str, list[FaultRule]]" = field(default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        # strict validation: every rule that can never fire as written
        # is an error HERE, with the clause spelled out, not a plan
        # that silently does nothing
        for site, site_rules in self.rules.items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"one of {SITES}")
            for r in site_rules:
                clause = r.clause(site)
                if r.kind not in KINDS:
                    raise ValueError(f"unknown fault kind {r.kind!r} in "
                                     f"{clause!r}; one of {KINDS}")
                if r.lo < 0:
                    raise ValueError(
                        f"negative call window start in {clause!r}")
                if not r.hi > r.lo:
                    raise ValueError(
                        f"empty call window in {clause!r}: hi ({r.hi:g}) "
                        f"must exceed lo ({r.lo})")
                if not 0.0 < r.p <= 1.0:
                    raise ValueError(
                        f"fire probability {r.p:g} in {clause!r} outside "
                        "(0, 1] — the rule would never/over fire")
                if r.kind == "hang" and r.seconds <= 0:
                    raise ValueError(
                        f"hang rule {clause!r} needs a positive duration: "
                        "write hang(seconds)")
                if r.kind != "hang" and r.seconds:
                    raise ValueError(
                        f"duration only applies to hang rules, got "
                        f"{clause!r}")
                if r.kind == "torn" and site != "broker":
                    raise ValueError(
                        f"torn is a broker-site kind (the caller must "
                        f"cooperate to tear a frame), got {clause!r}")
        self._lock = locks.named_lock("faults.plan")
        self.calls = {s: 0 for s in SITES}
        self.fired = {s: 0 for s in SITES}
        # zlib.crc32, not hash(): string hashing is per-process
        # randomized, and the whole point is that a SUBPROCESS replays
        # its parent's schedule exactly
        import zlib
        self._rng = {s: random.Random((self.seed << 8)
                                      ^ (zlib.crc32(s.encode()) & 0xFFFF))
                     for s in SITES}

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules: "dict[str, list[FaultRule]]" = {}
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            m = _RULE_RE.match(part)
            if not m:
                raise ValueError(f"bad fault rule {part!r}; grammar: "
                                 "site:kind[(seconds)]@lo[-hi][~p]")
            site, kind = m["site"], m["kind"]
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"one of {SITES}")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; "
                                 f"one of {KINDS}")
            lo = int(m["lo"])
            if m["span"] is None:
                hi: float = lo + 1
            else:
                hi = float("inf") if not m["hi"] else int(m["hi"])
            rules.setdefault(site, []).append(FaultRule(
                kind=kind, lo=lo, hi=hi,
                seconds=float(m["seconds"] or 0.0),
                p=float(m["p"] or 1.0)))
        return cls(rules=rules, seed=seed)

    # ---- the two consultation surfaces ----------------------------------

    def check(self, site: str) -> "FaultRule | None":
        """Count one call at ``site``; return the rule that fires for it
        (or None). Sites with caller-specific behavior (broker torn
        writes) use this and act themselves."""
        with self._lock:
            i = self.calls[site]
            self.calls[site] = i + 1
            for r in self.rules.get(site, ()):
                if r.covers(i) and (r.p >= 1.0
                                    or self._rng[site].random() < r.p):
                    self.fired[site] += 1
                    return r
        return None

    def fire(self, site: str) -> None:
        """check() + the standard action: fail ⇒ InjectedFault, crash ⇒
        InjectedCrash, hang ⇒ sleep, torn ⇒ returned to the caller via
        check() only."""
        r = self.check(site)
        if r is None:
            return
        if r.kind == "hang":
            time.sleep(r.seconds)
        elif r.kind == "crash":
            raise InjectedCrash(f"injected crash at {site} "
                                f"(call {self.calls[site] - 1})")
        elif r.kind == "fail":
            raise InjectedFault(f"injected {site} failure "
                                f"(call {self.calls[site] - 1})")
        # "torn" needs caller cooperation; fire() alone does nothing

    def stats(self) -> dict:
        with self._lock:
            return {"calls": dict(self.calls), "fired": dict(self.fired)}


# ---------------------------------------------------------------------------
# Active-plan registry (programmatic installs layered over the env plan)

_ENV_VAR = "RTPU_FAULTS"
_ENV_SEED = "RTPU_FAULT_SEED"
_lock = locks.named_lock("faults.registry")
_installed: "FaultPlan | None" = None
_env_plan: "FaultPlan | None | str" = "unset"   # lazy one-shot parse


def active() -> "FaultPlan | None":
    """The plan injection sites consult: an installed plan wins; else the
    env plan (parsed once — subprocesses inherit RTPU_FAULTS and replay
    the same schedule); else None (the common case: one dict lookup)."""
    global _env_plan
    if _installed is not None:
        return _installed
    if _env_plan == "unset":
        with _lock:
            if _env_plan == "unset":
                spec = os.environ.get(_ENV_VAR, "")
                _env_plan = (FaultPlan.parse(
                    spec, seed=int(os.environ.get(_ENV_SEED, "0")))
                    if spec else None)
    return _env_plan


def install(plan: "FaultPlan | None") -> None:
    global _installed
    _installed = plan


class use:
    """``with faults.use(plan):`` — install for a scope, restore after
    (tests/bench legs must never leak a plan into the next test)."""

    def __init__(self, plan: "FaultPlan | None"):
        self._plan = plan
        self._prev: "FaultPlan | None" = None

    def __enter__(self) -> "FaultPlan | None":
        global _installed
        self._prev = _installed
        _installed = self._plan
        return self._plan

    def __exit__(self, *exc) -> None:
        global _installed
        _installed = self._prev


def fire(site: str) -> None:
    """Module-level convenience: consult the active plan (no-op without
    one). The one line every injection site carries."""
    p = active()
    if p is not None:
        p.fire(site)


def check(site: str) -> "FaultRule | None":
    p = active()
    return None if p is None else p.check(site)


# ---------------------------------------------------------------------------
# Deterministic retry backoff (shared by the publisher + its tests)


def backoff_schedule(attempts: int, base_s: float, cap_s: float,
                     jitter: float = 0.1, seed: int = 0) -> "list[float]":
    """The publisher's bounded-exponential-with-jitter schedule as a PURE
    function: sleep[i] = min(cap, base·2^i)·(1 + jitter·u_i) with u_i from
    ``random.Random(seed)`` — same (attempts, base, cap, jitter, seed) ⇒
    same schedule, byte for byte, so tests pin determinism and a capture
    can name the exact delays a retried wave paid."""
    rng = random.Random(seed)
    out = []
    for i in range(max(0, int(attempts))):
        d = min(cap_s, base_s * (2.0 ** i))
        out.append(d * (1.0 + jitter * rng.random()))
    return out
