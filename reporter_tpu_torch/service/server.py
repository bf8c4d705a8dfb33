"""Stdlib threaded HTTP runner for the WSGI app, and the service's entry
point.

Counterpart: reporter_tpu/service/server.py. Loads the config, compiles
or loads the tiles, builds the app once (tables staged on the device,
the sweep arm calibrated), and serves threaded until SIGINT, which
drains the scheduler and the publisher before exiting 0.

Run:  python -m reporter_tpu_torch.service.server [--tiles tiles.npz]
      [--config cfg.json] [--host H] [--port P] [--device cuda|cpu]

``--tiles`` takes one ``.npz`` in the JAX package's layout (``python -m
reporter_tpu.tiles build`` or ``TileSet.save``); without it the synthetic
``sf`` is compiled. Several ``--tiles`` (the metro router, ROADMAP queue
1 item 1d) and ``--mode bicycle|foot`` (per-mode tiles, item 4) raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import logging
import time
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from reporter_tpu_torch.config import Config
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
    """A threaded WSGI server for ``app`` (not started: call
    ``serve_forever``, and ``shutdown`` / ``server_close`` after).
    ``port`` None takes the app's ``service.port``; 0 binds a free one
    (``server.server_address[1]``)."""
    if port is None:
        port = app.config.service.port
    return make_server(host, port, app, server_class=ThreadedWSGIServer,
                       handler_class=_QuietHandler)


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(
        description="reporter_tpu_torch report service")
    ap.add_argument("--tiles", nargs="*", default=None,
                    help="a compiled TileSet .npz (default: synthetic 'sf'); "
                         "several (the metro router) are not ported")
    ap.add_argument("--config", help="JSON config path")
    ap.add_argument("--mode", choices=("auto", "bicycle", "foot"),
                    help="transport mode served; only 'auto' is ported")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int)
    ap.add_argument("--device", default="cuda",
                    help="device of the matcher's tables: cuda (default) "
                         "or cpu")
    args = ap.parse_args(argv)

    if args.tiles is not None and len(args.tiles) > 1:
        raise NotImplementedError(
            "several --tiles start the metro router (service/router.py), "
            "which is not ported: ROADMAP queue 1 item 1d")
    if args.mode not in (None, "auto"):
        raise NotImplementedError(
            f"--mode {args.mode}: per-mode serving needs tiles compiled for "
            "the mode (RoadNetwork.for_mode), which are not ported: "
            "ROADMAP queue 1 item 4")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    t0 = time.perf_counter()
    config = Config.load(args.config)
    if args.tiles:
        ts = TileSet.load(args.tiles[0])
    else:
        from reporter_tpu_torch.netgen.synthetic import generate_city
        from reporter_tpu_torch.tiles.compiler import compile_network

        log.info("no --tiles given; compiling synthetic 'sf'")
        ts = compile_network(generate_city("sf"), config.compiler)
    app = make_app(ts, config, device=args.device)
    server = serve(app, args.host, args.port)
    log.info("serving %s (%d edges) on %s:%d, device %s, ready in %.2f s "
             "(tiles, staging and calibration)", ts.name, ts.num_edges,
             args.host, server.server_address[1], app.matcher.device,
             time.perf_counter() - t0)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # graceful drain: admitted batches finish (their clients get
        # responses), new admissions get 503, then the publisher closes
        log.info("shutting down: draining scheduler + publisher")
        app.close()
        server.server_close()


if __name__ == "__main__":
    main()
