"""End-to-end demo of the PyTorch / CUDA port: compile a city, match a
fleet, serve HTTP.

    python examples/torch_quickstart.py [--device cuda|cpu]

The counterpart of examples/quickstart.py on reporter_tpu_torch. Runs on
the card unless ``--device cpu`` is given; ``cuda`` on a host without
one raises.
"""

import argparse
import json
import os
import sys
import threading
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from reporter_tpu_torch import (  # noqa: E402
    CompilerParams,
    Config,
    SegmentMatcher,
    Trace,
    compile_network,
    generate_city,
    make_app,
)
from reporter_tpu_torch.netgen.traces import synthesize_fleet  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the matcher's tables "
                         "(default cuda)")
    args = ap.parse_args(argv)

    # 1. offline tile pipeline: road network → device-ready arrays
    ts = compile_network(generate_city("tiny"),
                         CompilerParams(osmlr_max_length=200.0))
    staged = sum(v.nbytes for v in ts.host_tables().values())
    print(f"tileset '{ts.name}': {ts.num_edges} edges, "
          f"{len(ts.osmlr_id)} OSMLR segments, "
          f"{staged / 1e6:.1f} MB of staged tables")

    # 2. batched matching on the device
    fleet = synthesize_fleet(ts, 8, num_points=60, seed=1)
    traces = [Trace(uuid=p.uuid, xy=p.xy.astype("float32"), times=p.times)
              for p in fleet]
    matcher = SegmentMatcher(ts, Config(), device=args.device)
    results = matcher.match_many(traces)
    print(f"matcher on {matcher.device}")
    for t, recs in zip(traces, results[:3]):
        ids = [r.segment_id for r in recs]
        print(f"  {t.uuid}: {len(recs)} segment records  {ids}")

    # 3. the report service over HTTP
    app = make_app(ts, Config(), transport=lambda url, body: 200,
                   device=args.device)
    import wsgiref.simple_server as ss

    class Quiet(ss.WSGIRequestHandler):
        def log_message(self, *a):
            pass

    httpd = ss.make_server("127.0.0.1", 0, app, handler_class=Quiet)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    payload = fleet[0].to_report_json()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/report",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    out = json.loads(urllib.request.urlopen(req, timeout=60).read())
    print(f"POST /report → {len(out['segments'])} segments, "
          f"{len(out['reports'])} fully-traversed reports")
    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=30).read())
    print(f"GET /stats → probes={stats['probes']:.0f} "
          f"p50_match={stats.get('match_seconds_p50', 0) * 1e3:.0f}ms")
    httpd.shutdown()
    app.close()


if __name__ == "__main__":
    main()
