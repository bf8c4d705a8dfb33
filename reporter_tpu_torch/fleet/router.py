"""FleetRouter: the metro router over a paged fleet.

Counterpart: reporter_tpu/fleet/router.py. It keeps MetroRouter's routing
(``_init_routing``: an explicit ``"metro"``, else the smallest box
holding the first point), WSGI surface and error answers, and changes
where apps come from and how they dispatch:

  - metros register cold; a metro's app (scheduler, cache, publisher)
    is built at its first traffic, one build lock per metro, and kept
    across paging: only its matcher's tables page (fleet/residency.py);
  - every dispatch runs under a residency lease, so promotion and
    dispatch are atomic against eviction;
  - per-metro SLOs (``MetroSLO``): the scheduler's batch close deadline,
    admission limit and batches in flight, and a residency pin for a
    metro whose SLO cannot absorb a promotion;
  - a trace outside every metro answers MetroRouter's 404 with
    ``known_metros``; a full fleet (all pinned or leased) sheds 503 as
    FleetCapacityError, a ServiceOverloaded;
  - ``/health`` adds the residency report and a quality roll-up,
    ``/stats`` a fleet section, and ``/metrics`` the one registry the
    router and the residency share (``rtpu_fleet_*``).

The name "fleet" is reserved: it keys the residency section of /stats.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch

from reporter_tpu_torch.config import Config
from reporter_tpu_torch.fleet.residency import FleetConfig, FleetResidency
from reporter_tpu_torch.service.app import ReporterApp
from reporter_tpu_torch.service.datastore import Transport
from reporter_tpu_torch.service.router import MetroRouter
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils import locks


@dataclass(frozen=True)
class MetroSLO:
    """Per-metro serving policy on the scheduler's levers; None keeps the
    base Config's value."""

    deadline_ms: "float | None" = None   # batch close (batch_close_ms)
    queue_limit: "int | None" = None     # admitted traces before 503
    #                                      (admission_queue_limit)
    max_inflight: "int | None" = None    # device batches in flight
    pinned: bool = False                 # never LRU-evicted

    def apply(self, base: Config) -> Config:
        kw: dict = {}
        if self.deadline_ms is not None:
            kw["batch_close_ms"] = float(self.deadline_ms)
        if self.queue_limit is not None:
            kw["admission_queue_limit"] = int(self.queue_limit)
        if self.max_inflight is not None:
            kw["max_inflight_batches"] = int(self.max_inflight)
        if not kw:
            return base
        return dataclasses.replace(
            base, service=dataclasses.replace(base.service, **kw)
        ).validate()


class FleetRouter(MetroRouter):
    """One serving face over many metros on one card, their tables on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, tilesets: Sequence[TileSet],
                 config: "Config | None" = None,
                 transport: "Transport | None" = None,
                 fleet: "FleetConfig | None" = None,
                 slos: "dict[str, MetroSLO] | None" = None,
                 device: "str | torch.device | None" = None):
        names = self._init_routing(tilesets)
        if "fleet" in names:
            raise ValueError('metro name "fleet" is reserved (it keys '
                             "the residency section in /stats)")
        base = (config or Config()).validate()
        slos = dict(slos or {})
        unknown = set(slos) - set(names)
        if unknown:
            raise ValueError(f"SLOs for unknown metros: {sorted(unknown)}")
        self._slos = slos
        self._transport = transport
        self._configs = {n: s.apply(base) for n, s in slos.items()}
        fleet = fleet or FleetConfig()
        pins = tuple(dict.fromkeys(
            fleet.pins + tuple(n for n, s in slos.items() if s.pinned)))
        # one registry for the router's and the residency's series: two
        # would each render an exposition of their own
        self.residency = FleetResidency(
            tilesets, config=base,
            fleet=dataclasses.replace(fleet, pins=pins),
            configs=self._configs, metrics=self.metrics, device=device)
        self.apps: "dict[str, ReporterApp]" = {}
        self._apps_lock = locks.named_lock("fleet_router.apps")
        # a build lock per metro: building an app promotes its metro
        # (staging, transfer, maybe a lease wait), which must not stall
        # the other metros' traffic behind one global lock
        self._app_build_locks = {
            n: locks.named_lock("fleet_router.app_build") for n in names}

    # ---- app and matcher access ------------------------------------------

    def app(self, name: str) -> ReporterApp:
        with self._apps_lock:
            a = self.apps.get(name)
        if a is not None:
            return a
        with self._app_build_locks[name]:   # KeyError: unknown metro
            with self._apps_lock:
                a = self.apps.get(name)
            if a is not None:
                return a
            # residency.matcher promotes if cold; the app wraps the
            # metro's long-lived matcher, so its cache and scheduler
            # outlive paging
            a = ReporterApp(
                self.residency.tileset(name),
                self._configs.get(name, self.residency.config),
                transport=self._transport,
                matcher=self.residency.matcher(name))
            with self._apps_lock:
                self.apps[name] = a
            return a

    @contextlib.contextmanager
    def _serving(self, metro: str):
        """A residency lease around the dispatch: promote if cold, and
        hold the tables resident until the reports are built."""
        with self.residency.lease(metro):
            yield

    # ---- observability ---------------------------------------------------

    def health(self) -> dict:
        with self._apps_lock:
            apps = dict(self.apps)
        return {
            "status": "ok",
            "unroutable": int(self.metrics.value("router_unroutable")),
            "fleet": self.residency.occupancy(),
            # the metros whose quality window is drifted, and the
            # fleet's drift events (each metro's window is in its block)
            "quality": {
                "drifted_metros": sorted(
                    n for n, a in apps.items()
                    if a.matcher.quality.drifted),
                "drift_events": sum(
                    a.matcher.quality.health()["drift_events"]
                    for a in apps.values()),
            },
            # metros that have seen traffic; the fleet block covers
            # every registered metro
            "metros": {n: a.health() for n, a in apps.items()},
        }

    def stats(self) -> dict:
        with self._apps_lock:
            apps = dict(self.apps)
        out = {n: a.matcher.metrics.snapshot() for n, a in apps.items()}
        out["fleet"] = {
            "occupancy": self.residency.occupancy(),
            "series": self.metrics.snapshot(),
        }
        return out

    def close(self) -> None:
        with self._apps_lock:
            apps = dict(self.apps)
        for a in apps.values():
            a.close()


def make_fleet_router(tilesets: Sequence[TileSet],
                      config: "Config | None" = None,
                      transport: "Transport | None" = None,
                      fleet: "FleetConfig | None" = None,
                      slos: "dict[str, MetroSLO] | None" = None,
                      device: "str | torch.device | None" = None,
                      ) -> FleetRouter:
    """A FleetRouter over ``tilesets``, their tables paged on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    return FleetRouter(tilesets, config, transport, fleet=fleet, slos=slos,
                       device=device)
