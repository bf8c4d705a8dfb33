"""The report service: the JAX package's service layer over the port's
matcher. ``make_app`` builds the WSGI app (``POST /report``,
``/report_many``; ``GET /health``, ``/stats``, ``/metrics``), ``serve``
(service/server.py) runs it on a stdlib threaded HTTP server, and
``python -m reporter_tpu_torch.service.server`` is the entry point."""

from reporter_tpu_torch.service.app import ReporterApp, make_app
from reporter_tpu_torch.service.cache import PartialTraceCache
from reporter_tpu_torch.service.datastore import DatastorePublisher
from reporter_tpu_torch.service.reports import build_reports, filter_segments
from reporter_tpu_torch.service.scheduler import (BatchScheduler,
                                                  ServiceOverloaded)

__all__ = [
    "ReporterApp",
    "make_app",
    "PartialTraceCache",
    "DatastorePublisher",
    "BatchScheduler",
    "ServiceOverloaded",
    "build_reports",
    "filter_segments",
]
