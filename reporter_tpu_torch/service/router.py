"""MetroRouter — one service over several metros (BASELINE config 4's
serving face).

Counterpart: reporter_tpu/service/router.py. Every metro's tables stay
staged on the card at once, one ReporterApp (and matcher, tuned for its
own tile) per metro, behind one endpoint. A request goes to a metro by an
explicit ``"metro"`` payload field, or by its trace's first point inside
a metro's lon/lat bounding box, dilated by ``_MARGIN_M``; where boxes
overlap or nest, the smallest box wins, whatever the order of the
tilesets.

Routes: ``POST /report``, ``/report_many`` (each result gains
``"metro"``), ``GET /health`` (a ``metros`` block, one app's /health
each), ``/stats`` (each metro's registry) and ``/metrics`` (the router's
own series: ``router_unroutable``). A trace outside every metro answers
404 with ``known_metros``; an unknown explicit metro 400. Every request
reaches its metro's app through ``app()`` and dispatches inside
``_serving()``, the two seams the fleet router (fleet/router.py)
overrides: apps built at first traffic, each dispatch under a residency
lease.

``meshes=`` ({metro name: parallel.mesh.Mesh}) deploys each listed
metro's matcher across its own devices (BASELINE config 4's product
shape: metros routed on the host, data parallelism within each metro's
mesh); metros without an entry stay on ``device``. A mesh for an
unknown metro raises ValueError.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Sequence

import numpy as np
import torch

from reporter_tpu_torch.config import Config
from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.service.app import (BadRequest, ReporterApp,
                                            _read_json, _respond,
                                            _respond_text)
from reporter_tpu_torch.service.datastore import Transport
from reporter_tpu_torch.service.scheduler import ServiceOverloaded
from reporter_tpu_torch.tiles.tileset import TileSet
from reporter_tpu_torch.utils.metrics import MetricsRegistry

_MARGIN_M = 2000.0    # bbox dilation: probes just outside the grid still route


class UnroutableTrace(BadRequest):
    """A trace outside every metro's dilated box, with no explicit
    ``"metro"``. The WSGI face answers 404 with the known metros (the
    caller can re-aim) and the router counts it (``router_unroutable``);
    a BadRequest, so callers' handling of bad requests still catches
    it."""

    def __init__(self, msg: str, known_metros: "list[str]"):
        super().__init__(msg)
        self.known_metros = known_metros


class MetroRouter:
    """WSGI app dispatching to per-metro ReporterApps, each with its
    tables on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``) or across its mesh of ``meshes``."""

    def __init__(self, tilesets: Sequence[TileSet],
                 config: "Config | None" = None,
                 transport: "Transport | None" = None,
                 meshes: "dict | None" = None,
                 device: "str | torch.device | None" = None):
        names = self._init_routing(tilesets)
        meshes = meshes or {}
        unknown = set(meshes) - set(names)
        if unknown:
            raise ValueError(f"meshes for unknown metros: {sorted(unknown)}")
        self.apps = {ts.name: ReporterApp(
            ts, config, transport=transport,
            device=None if ts.name in meshes else device,
            mesh=meshes.get(ts.name)) for ts in tilesets}

    def _init_routing(self, tilesets: Sequence[TileSet]) -> "list[str]":
        """The routing state (the box table and the router's registry),
        apart from the apps, so that a router building its apps another
        way (the fleet router, fleet/router.py) can reuse it."""
        if not tilesets:
            raise ValueError("need at least one tileset")
        names = [ts.name for ts in tilesets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate metro names: {names}")
        self.metrics = MetricsRegistry()   # the router's own series
        self._bounds = {ts.name: self._lonlat_bounds(ts) for ts in tilesets}
        # nested or overlapping metros route to the smallest containing
        # box (the most specific), whatever the --tiles order
        self._by_area = sorted(
            self._bounds.items(),
            key=lambda kv: ((kv[1][1][0] - kv[1][0][0])
                            * (kv[1][1][1] - kv[1][0][1])))
        return names

    def known_metros(self) -> "list[str]":
        return sorted(self._bounds)

    def app(self, name: str) -> ReporterApp:
        """The metro's app: the access point a subclass overrides (the
        fleet router builds it at first traffic)."""
        return self.apps[name]

    @contextlib.contextmanager
    def _serving(self, metro: str):
        """The dispatch context of one metro's batch, entered after
        ``app()``: nothing here (every table stays staged); the fleet
        router holds a residency lease, so the tables cannot page out
        under a dispatch."""
        yield

    @staticmethod
    def _lonlat_bounds(ts: TileSet):
        # the JAX router's arithmetic: f32 node positions dilated in f32,
        # converted in f64, so both packages route a boundary point alike
        lo = ts.node_xy.min(axis=0) - _MARGIN_M
        hi = ts.node_xy.max(axis=0) + _MARGIN_M
        corners = xy_to_lonlat(np.array([lo, hi]),
                               np.asarray(ts.meta.origin_lonlat))
        return corners[0], corners[1]   # (lon_lo, lat_lo), (lon_hi, lat_hi)

    # ---- routing ---------------------------------------------------------

    def route(self, payload: dict) -> str:
        """The metro of one payload: its explicit field, else the box
        holding its first point."""
        if not isinstance(payload, dict):
            raise BadRequest("payload must be a JSON object")
        metro = payload.get("metro")
        if metro is not None:
            if metro not in self._bounds:
                raise BadRequest(
                    f"unknown metro {metro!r}; have {self.known_metros()}")
            return str(metro)
        pts = payload.get("trace")
        if not isinstance(pts, list) or not pts or not isinstance(pts[0], dict):
            raise BadRequest("missing or empty 'trace'")
        try:
            lon = float(pts[0]["lon"])
            lat = float(pts[0]["lat"])
        except (KeyError, TypeError, ValueError):
            raise BadRequest("trace points need 'lat' and 'lon'")
        for name, (lo, hi) in self._by_area:
            if lo[0] <= lon <= hi[0] and lo[1] <= lat <= hi[1]:
                return name
        self.metrics.count("router_unroutable")
        raise UnroutableTrace(
            f"point ({lat:.4f}, {lon:.4f}) is outside every metro "
            f"({self.known_metros()})", self.known_metros())

    def report_one(self, payload: dict) -> dict:
        metro = self.route(payload)
        app = self.app(metro)
        with self._serving(metro):
            out = app.report_one(payload)
        out["metro"] = metro
        return out

    def report_many(self, payloads: list) -> list:
        """Every payload routed first (one bad payload fails the call
        before any match), then one report_many per metro; results in
        input order."""
        routed = [self.route(p) for p in payloads]
        by_metro: "dict[str, list[int]]" = {}
        for i, m in enumerate(routed):
            by_metro.setdefault(m, []).append(i)
        results: list = [None] * len(payloads)
        for m, idxs in by_metro.items():
            app = self.app(m)
            with self._serving(m):
                outs = app.report_many([payloads[i] for i in idxs])
            for i, out in zip(idxs, outs):
                out["metro"] = m
                results[i] = out
        return results

    # ---- WSGI ------------------------------------------------------------

    def health(self) -> dict:
        return {
            "status": "ok",
            "unroutable": int(self.metrics.value("router_unroutable")),
            "metros": {n: a.health() for n, a in self.apps.items()},
        }

    def stats(self) -> dict:
        return {n: a.matcher.metrics.snapshot()
                for n, a in self.apps.items()}

    def render_prometheus(self) -> str:
        """The router's own series (each metro's registry stays on its
        app's /metrics)."""
        return self.metrics.render_prometheus()

    def close(self) -> None:
        """Drain every metro's scheduler and publisher."""
        for a in self.apps.values():
            a.close()

    def __call__(self, environ: dict, start_response: Callable):
        method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")
        try:
            if path == "/health" and method == "GET":
                return _respond(start_response, 200, self.health())
            if path == "/stats" and method == "GET":
                return _respond(start_response, 200, self.stats())
            if path == "/metrics" and method == "GET":
                return _respond_text(start_response, 200,
                                     self.render_prometheus())
            if path == "/report" and method == "POST":
                return _respond(start_response, 200,
                                self.report_one(_read_json(environ)))
            if path == "/report_many" and method == "POST":
                body = _read_json(environ)
                traces = body.get("traces") if isinstance(body, dict) else None
                if not isinstance(traces, list):
                    raise BadRequest("payload must be {'traces': [...]}")
                return _respond(start_response, 200,
                                {"results": self.report_many(traces)})
            if path in ("/report", "/report_many"):
                return _respond(start_response, 405,
                                {"error": f"{method} not allowed"})
            return _respond(start_response, 404, {"error": "not found"})
        except UnroutableTrace as exc:
            # not found, not a bad request: the trace is well formed, but
            # no metro here serves that place; name the ones that do
            return _respond(start_response, 404, {
                "error": str(exc), "known_metros": exc.known_metros})
        except BadRequest as exc:
            return _respond(start_response, 400, {"error": str(exc)})
        except ServiceOverloaded as exc:
            return _respond(start_response, 503, {"error": str(exc)})
        except Exception:                                 # pragma: no cover
            logging.getLogger("reporter_tpu_torch.router").exception(
                "unhandled error serving %s %s", method, path)
            return _respond(start_response, 500, {"error": "internal error"})


def make_router(tilesets: Sequence[TileSet], config: "Config | None" = None,
                transport: "Transport | None" = None,
                meshes: "dict | None" = None,
                device: "str | torch.device | None" = None) -> MetroRouter:
    """A MetroRouter over ``tilesets``, every metro's tables on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``) or across its
    mesh of ``meshes``."""
    return MetroRouter(tilesets, config, transport, meshes=meshes,
                       device=device)
