"""Fleet residency: many compiled metros on one card, their tables paged.

Counterpart: reporter_tpu/fleet/residency.py, with its names, its
policy, its ledger, its series and its fault site. One metro's staged
tables are small next to an 80 GB card (sf 2.7 MB, organic 27 MB:
tiles/capacity.py), so one card serves many metros; when their tables
outgrow a budget, the least recently used page out:

  hot tier   metros whose tables are placed on the card, serving;
  cold tier  the staged dict each metro's first touch builds
             (``TileSet.host_tables``, the seg_pack build done once),
             kept in host memory: on ``cuda`` as page-locked (pinned) CPU
             tensors, pinned once at first touch and reused by every
             later promotion (a failure to pin raises); on
             ``device="cpu"`` as plain CPU tensors, nothing pinned (the
             device the caller asked for, not a fallback);
  paging     a touch of a cold metro promotes it inside a counted, traced
             ``fleet_promote`` span: one ``.to(device, non_blocking=True)``
             per table from pinned memory on the fleet's copy stream,
             then a host wait on an event recorded after the copies (the
             bound ``jax.block_until_ready`` gives the JAX fleet), then
             ``restage_tables`` on the metro's long-lived SegmentMatcher,
             which keeps its walker, route tables and tuned plan and
             never re-tunes. The copied tensors are marked used by the
             default stream (``record_stream``), where every dispatch of
             the port runs, so the caching allocator cannot hand their
             blocks to a later copy while a queued kernel still reads
             them. Demotion drops the references: the blocks return to
             the caching allocator (``memory_allocated`` falls,
             ``memory_reserved`` does not), kernels already queued read
             them first by stream order, and ``torch.cuda.empty_cache``
             is never called (it synchronizes the device and would stall
             the other metros).

Capacity policy (``FleetConfig``): a budget of staged bytes, LRU eviction
that drains occupancy below a watermark fraction of the budget (so a
fleet at the boundary does not page on every other request), and pins for
SLO metros that are never LRU-evicted. A metro mid-dispatch (leased) is
never evicted: the lease makes promote and dispatch atomic against
eviction. The ledger counts staged bytes (``staged_nbytes``, equal to the
matcher's ``table_bytes``), not the allocator's 512-byte blocks.

Records: a fleet-resident metro's wire bytes equal a dedicated
SegmentMatcher's for the same traces, also right after an evict →
promote cycle, because promotion places the same host values again and
the matcher dispatches the same kernels on them.

The page-in watchdog (``promote_timeout_s`` > 0) runs the transfer on a
daemon thread (utils/watchdog.py), where the ``fleet_promote`` fault site
fires. A CUDA copy cannot be cancelled: on timeout the thread is
abandoned, the promotion sheds a retryable 503 (``ServiceOverloaded``)
and rolls the ledger back, and abandoned transfers count toward the
watchdog's breaker.

Series (``rtpu_fleet_*``, per metro through ``labeled``): hits, misses,
promotions, demotions, evictions, promote waits, failures, timeouts,
resident bytes and flags, the ``fleet_promote_seconds`` histogram, and
the ``fleet_stage`` / ``fleet_matcher_build`` stage timers (first-touch
costs, metered apart from paging).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from reporter_tpu_torch import faults
from reporter_tpu_torch.config import Config
from reporter_tpu_torch.device import resolve_device
from reporter_tpu_torch.matcher.api import SegmentMatcher
from reporter_tpu_torch.service.scheduler import ServiceOverloaded
from reporter_tpu_torch.tiles.tileset import (HOST_KEYS, TileSet,
                                              place_tables, staged_nbytes)
from reporter_tpu_torch.utils import locks, tracing
from reporter_tpu_torch.utils import watchdog as watchdog_mod
from reporter_tpu_torch.utils.metrics import MetricsRegistry, labeled
from reporter_tpu_torch.utils.watchdog import AbandonedThreadWatchdog


class FleetCapacityError(ServiceOverloaded):
    """No way to make a metro resident: the budget is full of pinned or
    mid-dispatch metros, or the metro alone exceeds it. A
    ServiceOverloaded, so the WSGI face sheds it as a retryable 503."""


@dataclass(frozen=True)
class FleetConfig:
    """The residency policy. ``with_env_overrides`` applies the
    ``RTPU_FLEET_*`` variables, checked strictly."""

    max_resident_bytes: int = 0        # budget of staged bytes; 0 =
    #                                    unbounded (every metro promotes
    #                                    once and stays)
    evict_watermark: float = 0.85      # eviction drains occupancy, the
    #                                    incoming metro included, below
    #                                    this fraction of the budget
    pins: tuple[str, ...] = ()         # metros never LRU-evicted (their
    #                                    bytes still count)
    promote_wait_s: float = 5.0        # a promotion blocked only by
    #                                    in-flight leases waits this long
    #                                    for them before shedding 503;
    #                                    0 = shed at once
    promote_timeout_s: float = 0.0     # the page-in watchdog's bound on
    #                                    one transfer (size it for the
    #                                    table bytes); 0 = off

    def validate(self) -> "FleetConfig":
        if self.max_resident_bytes < 0:
            raise ValueError("fleet.max_resident_bytes must be >= 0")
        if not 0.0 < self.evict_watermark <= 1.0:
            raise ValueError("fleet.evict_watermark must be in (0, 1]")
        if self.promote_wait_s < 0:
            raise ValueError("fleet.promote_wait_s must be >= 0")
        if self.promote_timeout_s < 0:
            raise ValueError("fleet.promote_timeout_s must be >= 0")
        return self

    def with_env_overrides(self, env: "dict[str, str] | None" = None,
                           ) -> "FleetConfig":
        e = os.environ if env is None else env
        kw: dict = {}
        if "RTPU_FLEET_MAX_BYTES" in e:
            kw["max_resident_bytes"] = int(float(e["RTPU_FLEET_MAX_BYTES"]))
        if "RTPU_FLEET_WATERMARK" in e:
            kw["evict_watermark"] = float(e["RTPU_FLEET_WATERMARK"])
        if "RTPU_FLEET_PROMOTE_WAIT" in e:
            kw["promote_wait_s"] = float(e["RTPU_FLEET_PROMOTE_WAIT"])
        if "RTPU_FLEET_PROMOTE_TIMEOUT" in e:
            kw["promote_timeout_s"] = float(e["RTPU_FLEET_PROMOTE_TIMEOUT"])
        if "RTPU_FLEET_PINS" in e:
            extra = tuple(p.strip() for p in e["RTPU_FLEET_PINS"].split(",")
                          if p.strip())
            kw["pins"] = tuple(dict.fromkeys(self.pins + extra))
        return dataclasses.replace(self, **kw) if kw else self


class _Metro:
    """One metro's residency entry (mutated under the fleet lock)."""

    __slots__ = ("name", "tileset", "host", "matcher", "staged_bytes",
                 "resident", "pinned", "promoting", "reserved",
                 "last_used", "leases", "promotions", "demotions")

    def __init__(self, tileset: TileSet, pinned: bool):
        self.name = tileset.name
        self.tileset = tileset
        self.host: "dict | None" = None       # the cold tier's staged dict
        self.matcher: "SegmentMatcher | None" = None
        self.staged_bytes = 0                 # known after first staging
        self.resident = False
        self.pinned = pinned
        self.promoting = False                # a thread is paging it in,
        #                                       the fleet lock dropped;
        #                                       other touches wait
        self.reserved = False                 # its bytes are in the
        #                                       ledger (resident, or past
        #                                       the reservation of a
        #                                       promotion): only these can
        #                                       be freed by waiting
        self.last_used = 0                    # LRU clock (a sequence)
        self.leases = 0                       # dispatches in flight
        self.promotions = 0
        self.demotions = 0


class FleetResidency:
    """The registry of compiled metros and the ledger of staged bytes on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``; a
    fleet for ``cuda`` without a card raises).

    Every tileset registers cold: no memory, no staging; its first touch
    stages it. ``configs`` holds per-metro Config overrides (the fleet
    router's SLOs); other metros share ``config``. One lock guards the
    ledger (bytes, tiers, LRU, leases); the expensive phases of a
    promotion (the first touch's staging build, the transfer, the first
    matcher's construction) run with it released behind the metro's
    ``promoting`` flag, the bytes reserved in the ledger first, so one
    cold metro's page-in never stalls another metro's lease and two
    promoters cannot oversubscribe the budget."""

    def __init__(self, tilesets: Sequence[TileSet],
                 config: "Config | None" = None,
                 fleet: "FleetConfig | None" = None,
                 configs: "dict[str, Config] | None" = None,
                 metrics: "MetricsRegistry | None" = None,
                 device: "str | torch.device | None" = None):
        if not tilesets:
            raise ValueError("need at least one tileset")
        names = [ts.name for ts in tilesets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate metro names: {names}")
        self.config = (config or Config()).validate()
        if self.config.matcher_backend != "torch":
            raise ValueError("fleet residency pages DEVICE tables; "
                             "matcher_backend must be 'torch'")
        self.fleet = (fleet or FleetConfig()).with_env_overrides().validate()
        unknown_pins = set(self.fleet.pins) - set(names)
        if unknown_pins:
            raise ValueError(f"pins for unknown metros: "
                             f"{sorted(unknown_pins)}")
        self._configs = dict(configs or {})
        unknown_cfg = set(self._configs) - set(names)
        if unknown_cfg:
            raise ValueError(f"configs for unknown metros: "
                             f"{sorted(unknown_cfg)}")
        off_device = sorted(n for n, c in self._configs.items()
                            if c.matcher_backend != "torch")
        if off_device:
            # at construction, not at the metro's first touch (it would
            # answer 503 for ever)
            raise ValueError(f"per-metro configs must keep "
                             f"matcher_backend='torch': {off_device}")
        self.device = resolve_device(device)
        self.metrics = metrics or MetricsRegistry()
        self._lock = locks.named_lock("fleet.ledger")
        # one condvar on the ledger lock for both wake-ups: a lease
        # released (a blocked promotion may now evict) and a promotion
        # finished (its other touchers were waiting for it)
        self._cond = locks.named_condition("fleet.ledger", lock=self._lock)
        self._seq = 0
        self._resident_bytes = 0
        self._resident_count = 0
        # the page-in breaker, with its own lock: an abandoned transfer
        # un-counts itself without the fleet lock
        self._watchdog = AbandonedThreadWatchdog(
            cap=4, thread_name="fleet-promote-watchdog")
        # the promotions' copies run here, apart from the dispatches
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._metros = {ts.name: _Metro(ts, ts.name in self.fleet.pins)
                        for ts in tilesets}
        self.metrics.gauge("fleet_capacity_bytes",
                           self.fleet.max_resident_bytes)
        self.metrics.gauge("fleet_registered_metros", len(self._metros))
        self._publish_occupancy_locked()

    # ---- read side -------------------------------------------------------

    @property
    def names(self) -> "list[str]":
        return sorted(self._metros)

    @property
    def resident_names(self) -> "list[str]":
        with self._lock:
            return sorted(n for n, m in self._metros.items() if m.resident)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def tileset(self, name: str) -> TileSet:
        return self._metros[name].tileset

    def occupancy(self) -> dict:
        """The ledger's totals and each metro's residency (/health's
        fleet block)."""
        with self._lock:
            metros = {
                n: {"resident": m.resident, "pinned": m.pinned,
                    "staged_bytes": m.staged_bytes,
                    "promotions": m.promotions, "demotions": m.demotions,
                    "leases": m.leases, "last_used_seq": m.last_used,
                    # the sweep plan serving the metro (None: cold, a
                    # CPU fleet, or explicit levers)
                    "tuned_plan": (m.matcher.tuned_plan.label
                                   if m.matcher is not None
                                   and m.matcher.tuned_plan is not None
                                   else None)}
                for n, m in sorted(self._metros.items())}
            occ = self._resident_bytes
        cap = self.fleet.max_resident_bytes
        return {
            "capacity_bytes": cap,
            "evict_watermark": self.fleet.evict_watermark,
            "resident_bytes": occ,
            "occupancy_frac": (occ / cap if cap else None),
            "resident_metros": sum(1 for m in metros.values()
                                   if m["resident"]),
            "registered_metros": len(metros),
            "promotions": int(self.metrics.value("fleet_promotions_total")),
            "demotions": int(self.metrics.value("fleet_demotions_total")),
            "metros": metros,
        }

    # ---- serving side ----------------------------------------------------

    @contextlib.contextmanager
    def lease(self, name: str) -> Iterator[SegmentMatcher]:
        """Promote if cold and hold the metro resident for the body: the
        way to dispatch, since eviction skips leased metros."""
        with self._lock:
            m = self._touch_locked(name)
            m.leases += 1
        try:
            yield m.matcher
        finally:
            with self._lock:
                m.leases -= 1
                if m.leases == 0:
                    # a promotion may be waiting for it to be evictable
                    self._cond.notify_all()

    def matcher(self, name: str) -> SegmentMatcher:
        """Touch and promote if cold, without a lease: for construction
        (the router building a metro's app). Dispatch through
        ``lease()``."""
        with self._lock:
            return self._touch_locked(name).matcher

    def promote(self, name: str) -> None:
        with self._lock:
            self._touch_locked(name)

    def demote(self, name: str) -> None:
        """Page a metro out (eviction's path, as a lever). A pinned metro
        can be demoted this way: the pin only shields it from the LRU
        scan. No-op when cold; refused while the metro is leased."""
        with self._lock:
            m = self._metros[name]
            if m.leases > 0:
                raise RuntimeError(
                    f"metro {name!r} has {m.leases} dispatch(es) in "
                    "flight; cannot demote under a lease")
            if m.resident:
                self._demote_locked(m)

    def set_capacity(self, max_resident_bytes: int) -> None:
        """Change the budget live. Below the occupancy it evicts LRU at
        once; pinned and leased metros can leave the fleet over budget."""
        with self._lock:
            # swapped under the lock: a promotion reads self.fleet once
            self.fleet = dataclasses.replace(
                self.fleet, max_resident_bytes=int(max_resident_bytes)
            ).validate()
            self.metrics.gauge("fleet_capacity_bytes",
                               self.fleet.max_resident_bytes)
            cap = self.fleet.max_resident_bytes
            if cap:
                self._evict_locked(
                    need=0, budget=int(cap * self.fleet.evict_watermark))
            self._publish_occupancy_locked()

    # ---- internals (under self._lock) ------------------------------------

    def _touch_locked(self, name: str) -> _Metro:
        m = self._metros.get(name)
        if m is None:
            raise KeyError(f"unknown metro {name!r}; have {self.names}")
        self._seq += 1
        m.last_used = self._seq
        if m.resident:
            self.metrics.count(labeled("fleet_hits", metro=name))
            return m
        self.metrics.count(labeled("fleet_misses", metro=name))
        while True:
            if m.resident:              # a concurrent promoter finished
                return m
            if not m.promoting:
                self._promote_locked(m)
                return m
            # another thread is paging it in: wait for it to land (or
            # fail, and then promote it here)
            self._cond.wait()

    def _cold_tier(self, host: dict) -> dict:
        """The staged host dict as the cold tier keeps it: on ``cuda``
        each table pinned (page-locked) once, on the CPU each a tensor
        over the numpy array. The tag and plan stay numpy."""
        pin = self.device.type == "cuda"
        out = {}
        for k, v in host.items():
            if k in HOST_KEYS:
                out[k] = v
            else:
                t = torch.from_numpy(np.ascontiguousarray(v))
                out[k] = t.pin_memory() if pin else t
        return out

    def _promote_locked(self, m: _Metro) -> None:
        """Page ``m`` in. The lock is held on entry and exit; the staging
        build, the transfer and the first matcher's construction run
        with it released, ``m.promoting`` making this thread the metro's
        only promoter. The bytes are reserved before the transfer."""
        fleet = self.fleet      # one (cap, watermark, wait) for the whole
        #                         promotion: set_capacity may swap it
        m.promoting = True
        try:
            if m.host is None:
                # first touch: the staging build, done once and kept in
                # the cold tier (metered apart from paging), in the
                # layout of the metro's own candidate backend
                cfg_m = self._configs.get(m.name, self.config)
                self._lock.release()
                try:
                    with self.metrics.stage("fleet_stage"):
                        host = self._cold_tier(m.tileset.host_tables(
                            cfg_m.matcher.candidate_backend))
                finally:
                    self._lock.acquire()
                m.host = host
                m.staged_bytes = staged_nbytes(host)
            cap = fleet.max_resident_bytes
            if cap:
                if m.staged_bytes > cap:
                    # no eviction can make it fit: shed before the LRU
                    # scan, or every retry would strip the fleet cold
                    self.metrics.count(labeled(
                        "fleet_promote_failures", metro=m.name))
                    raise FleetCapacityError(
                        f"metro {m.name!r} staged tables "
                        f"({m.staged_bytes} B) exceed the fleet budget "
                        f"({cap} B); no eviction can make it fit")
                # the watermark's headroom, clamped to the cap for a
                # metro bigger than the watermark's share, so eviction
                # stops once it fits
                target = int(cap * fleet.evict_watermark)
                if m.staged_bytes > target:
                    target = cap
                deadline = time.monotonic() + fleet.promote_wait_s
                while True:
                    if self._resident_bytes + m.staged_bytes <= cap:
                        break
                    self._evict_locked(need=m.staged_bytes, budget=target)
                    if self._resident_bytes + m.staged_bytes <= cap:
                        break
                    # over budget after the scan: bytes held by in-flight
                    # leases or by a promotion past its reservation free
                    # soon, so wait for them (the condvar fires on both);
                    # pins, or too small a budget, shed now. A promoter
                    # still in its own wait holds no bytes yet and does
                    # not count as freeable.
                    transient = [x for x in self._metros.values()
                                 if x is not m and not x.pinned
                                 and x.reserved
                                 and ((x.resident and x.leases > 0)
                                      or x.promoting)]
                    freeable = sum(x.staged_bytes for x in transient)
                    remaining = deadline - time.monotonic()
                    if (not transient or remaining <= 0
                            or self._resident_bytes - freeable
                            + m.staged_bytes > cap):
                        self.metrics.count(labeled(
                            "fleet_promote_failures", metro=m.name))
                        raise FleetCapacityError(
                            f"cannot make {m.name!r} resident "
                            f"({m.staged_bytes} B): "
                            f"{self._resident_bytes} B of {cap} B held "
                            f"by pinned/in-flight metros")
                    self.metrics.count(labeled("fleet_promote_waits",
                                               metro=m.name))
                    self._cond.wait(remaining)
            # reserve, then transfer with the lock released (m is not
            # resident yet, so eviction does not see it)
            self._resident_bytes += m.staged_bytes
            m.reserved = True
            placed = False
            self._lock.release()
            try:
                t0 = time.perf_counter()
                with tracing.span("fleet_promote", metro=m.name,
                                  bytes=m.staged_bytes):
                    tables = self._transfer_guarded(m, fleet)
                    # the paging cost is the transfer (and the restage);
                    # the first matcher's construction, its tuner
                    # included, is metered apart
                    dt = time.perf_counter() - t0
                    if m.matcher is None:
                        with self.metrics.stage("fleet_matcher_build"):
                            m.matcher = SegmentMatcher(
                                m.tileset,
                                self._configs.get(m.name, self.config),
                                device=self.device, staged_tables=tables)
                        # the resolved plan into the cold tier: every
                        # later promotion places an already tuned dict
                        arr = m.matcher.tuned_plan_array()
                        if arr is not None and "tuned_plan" in m.host:
                            m.host["tuned_plan"] = arr
                    else:
                        m.matcher.restage_tables(tables)
                        dt = time.perf_counter() - t0
                placed = True
            finally:
                self._lock.acquire()
                if not placed:
                    self._resident_bytes -= m.staged_bytes
                    m.reserved = False
            self.metrics.observe("fleet_promote_seconds", dt)
            m.resident = True
            self._resident_count += 1
            m.promotions += 1
            self.metrics.count(labeled("fleet_promotions", metro=m.name))
            self.metrics.count("fleet_promotions_total")
            self._publish_metro_locked(m)
        finally:
            m.promoting = False
            self._cond.notify_all()     # this metro's waiters, and any
            #                             promoter waiting for capacity

    def _transfer(self, host: dict) -> dict:
        """The cold tier's dict placed on the device. On ``cuda``: each
        pinned table copied with ``non_blocking=True`` on the fleet's
        copy stream, an event recorded after the last copy and waited
        for on the host (the transfer's bound), each tensor marked used
        by the default stream, where the dispatches run."""
        dev, stream = self.device, self._copy_stream
        if stream is None:
            return place_tables(host, dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            placed = {k: v if k in HOST_KEYS
                      else v.to(dev, non_blocking=True)
                      for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        consumer = torch.cuda.default_stream(dev)
        for k, v in placed.items():
            if k not in HOST_KEYS:
                v.record_stream(consumer)
        return placed

    def _transfer_guarded(self, m: _Metro, fleet: FleetConfig) -> dict:
        """``_transfer`` of the metro's cold tier, bounded by the page-in
        watchdog when ``promote_timeout_s`` > 0, with the fleet lock
        released. On timeout the transfer's thread is abandoned (a CUDA
        copy cannot be cancelled) and the promotion sheds as a retryable
        ``ServiceOverloaded``; past the breaker's cap of abandoned
        transfers it sheds at once."""
        timeout = float(fleet.promote_timeout_s)
        if timeout <= 0:
            faults.fire("fleet_promote")
            return self._transfer(m.host)
        if self._watchdog.tripped:
            # the breaker is open: shed instead of pinning one more
            # thread and dict; counted as a timeout too
            self.metrics.count("fleet_promote_breaker_open")
            self.metrics.count(labeled("fleet_promote_timeouts",
                                       metro=m.name))
            tracing.post_mortem("fleet_promote_breaker",
                                failing="fleet_promote", metro=m.name,
                                abandoned=self._watchdog.abandoned)
            raise ServiceOverloaded(
                f"fleet promote breaker open "
                f"({self._watchdog.abandoned} transfers already stuck); "
                f"{m.name!r} not promoted")
        host = m.host
        out = self._watchdog.run(lambda: self._transfer(host), timeout,
                                 fault_site="fleet_promote")
        if out is not watchdog_mod.TIMED_OUT:
            return out
        self.metrics.count(labeled("fleet_promote_timeouts", metro=m.name))
        tracing.post_mortem("fleet_promote_timeout",
                            failing="fleet_promote", metro=m.name,
                            bytes=m.staged_bytes, timeout_s=timeout)
        raise ServiceOverloaded(
            f"fleet promote of {m.name!r} ({m.staged_bytes} B) exceeded "
            f"{timeout:.3f}s; shed for retry")

    def _evict_locked(self, need: int, budget: int) -> None:
        """Demote LRU unpinned, unleased metros until occupancy + need
        fits under ``budget``, or nothing evictable remains."""
        victims = sorted(
            (m for m in self._metros.values()
             if m.resident and not m.pinned and m.leases == 0),
            key=lambda m: m.last_used)
        for v in victims:
            if self._resident_bytes + need <= budget:
                break
            self._demote_locked(v)
            self.metrics.count(labeled("fleet_evictions", metro=v.name))

    def _demote_locked(self, m: _Metro) -> None:
        assert m.matcher is not None
        m.matcher.unstage_tables()      # the blocks return to the caching
        #                                 allocator; no empty_cache
        m.resident = False
        m.reserved = False
        self._resident_count -= 1
        m.demotions += 1
        self._resident_bytes -= m.staged_bytes
        self.metrics.count(labeled("fleet_demotions", metro=m.name))
        self.metrics.count("fleet_demotions_total")
        self._publish_metro_locked(m)

    def _publish_metro_locked(self, m: _Metro) -> None:
        """One metro's gauges and the ledger's totals: O(1) per paging
        event under the lock every lease needs."""
        self.metrics.gauge(labeled("fleet_resident_bytes", metro=m.name),
                           m.staged_bytes if m.resident else 0)
        self.metrics.gauge(labeled("fleet_resident", metro=m.name),
                           1.0 if m.resident else 0.0)
        self.metrics.gauge("fleet_resident_bytes_total",
                           self._resident_bytes)
        self.metrics.gauge("fleet_resident_metros", self._resident_count)

    def _publish_occupancy_locked(self) -> None:
        """Every metro's gauges: construction and a budget change only."""
        for m in self._metros.values():
            self._publish_metro_locked(m)
