"""Stdlib threaded HTTP runner for the WSGI app, and the service's entry
point.

Counterpart: reporter_tpu/service/server.py. Loads the config, compiles
or loads the tiles, builds the app once (tables staged on the device,
the sweep arm calibrated), and serves threaded until SIGINT, which
drains the scheduler and the publisher before exiting 0.

Run:  python -m reporter_tpu_torch.service.server [--tiles a.npz [b.npz
      ...]] [--config cfg.json] [--mode auto|bicycle|foot] [--host H]
      [--port P] [--device cuda|cpu]

``--tiles`` takes ``.npz`` files in the layout ``TileSet.save`` writes in
either package: a tile compiled with ``compile_network(net, mode=...)``
for a mode, with turn restrictions or not. Without it the synthetic
``sf`` is compiled. One tile serves a ReporterApp; several start the
metro router (service/router.py): every metro's tables staged on the
device and its arm calibrated, one endpoint routing each request by its
``"metro"`` field or its first point, and SIGINT draining every metro.
``--mode`` tags the service with its transport mode (a request naming
another mode gets 400); without ``--config`` it also applies the mode's
``MatcherParams.preset``, and with one the file's matcher parameters win.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from reporter_tpu_torch.config import Config, MatcherParams
from reporter_tpu_torch.service.app import make_app
from reporter_tpu_torch.tiles.tileset import TileSet

log = logging.getLogger("reporter_tpu_torch.service")


class ThreadedWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets connections
    # as soon as a few dozen clients connect at once
    request_queue_size = 1024


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):      # route through logging, not stderr
        logging.getLogger("reporter_tpu_torch.http").info(fmt, *args)


def serve(app, host: str = "0.0.0.0", port: "int | None" = None):
    """A threaded WSGI server for ``app``, a ReporterApp or a MetroRouter
    (not started: call ``serve_forever``, and ``shutdown`` /
    ``server_close`` after). ``port`` None takes the app's
    ``service.port`` (a router's: any member app's); 0 binds a free one
    (``server.server_address[1]``)."""
    if port is None:
        cfg = getattr(app, "config", None)
        if cfg is None:          # a MetroRouter: any member app's config
            cfg = next(iter(app.apps.values())).config
        port = cfg.service.port
    return make_server(host, port, app, server_class=ThreadedWSGIServer,
                       handler_class=_QuietHandler)


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(
        description="reporter_tpu_torch report service")
    ap.add_argument("--tiles", nargs="*", default=None,
                    help="compiled TileSet .npz path(s); several start the "
                         "multi-metro router (default: synthetic 'sf')")
    ap.add_argument("--config", help="JSON config path")
    ap.add_argument("--mode", choices=("auto", "bicycle", "foot"),
                    help="transport mode served: tags and checks requests, "
                         "and applies the mode's matcher preset unless "
                         "--config is given (pair with tiles compiled for "
                         "the mode)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int)
    ap.add_argument("--device", default="cuda",
                    help="device of the matcher's tables: cuda (default) "
                         "or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    t0 = time.perf_counter()
    config = Config.load(args.config)
    if args.mode:
        # a mounted --config keeps its tuned matcher parameters; --mode
        # then only tags the service
        matcher = (config.matcher if args.config
                   else MatcherParams.preset(args.mode))
        if args.config:
            log.info("--mode %s: matcher params come from --config; "
                     "preset not applied", args.mode)
        config = dataclasses.replace(
            config, matcher=matcher,
            service=dataclasses.replace(config.service, mode=args.mode))
    if args.tiles:
        tilesets = [TileSet.load(p) for p in args.tiles]
    else:
        from reporter_tpu_torch.netgen.synthetic import generate_city
        from reporter_tpu_torch.tiles.compiler import compile_network

        log.info("no --tiles given; compiling synthetic 'sf'")
        tilesets = [compile_network(generate_city("sf"), config.compiler)]
    if len(tilesets) == 1:
        ts = tilesets[0]
        app = make_app(ts, config, device=args.device)
        desc = f"{ts.name} ({ts.num_edges} edges)"
        device = app.matcher.device
    else:
        from reporter_tpu_torch.service.router import make_router

        app = make_router(tilesets, config, device=args.device)
        desc = "router[" + ", ".join(ts.name for ts in tilesets) + "]"
        device = next(iter(app.apps.values())).matcher.device
    server = serve(app, args.host, args.port)
    log.info("serving %s on %s:%d, device %s, ready in %.2f s "
             "(tiles, staging and calibration)", desc, args.host,
             server.server_address[1], device, time.perf_counter() - t0)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # graceful drain: admitted batches finish (their clients get
        # responses), new admissions get 503, then the publisher closes;
        # a router drains every metro's
        log.info("shutting down: draining scheduler + publisher")
        app.close()
        server.server_close()


if __name__ == "__main__":
    main()
