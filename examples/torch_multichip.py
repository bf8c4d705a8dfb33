"""Multi-device deployment demo of the PyTorch / CUDA port: the SAME
product code, dp-sharded.

    python examples/torch_multichip.py [--device cuda|cpu]

The counterpart of examples/multichip.py on reporter_tpu_torch. The mesh
is a process-local array of torch devices, and a device may repeat: this
demo shards over ``[device] * 4`` (four shards in turn on one card, or on
the CPU), and the same code shards over four cards given four names
(``cuda:0`` .. ``cuda:3``). Three rungs:

  1. SegmentMatcher(mesh=...)      — batched matching, rows sharded
  2. make_app(mesh=...)            — the HTTP service on the mesh
  3. make_router(meshes={...})     — config 4: metros on their own
                                     submeshes (EP × DP)

The records equal the single-device matcher's, asserted below as
tests/test_torch_parallel.py does. Runs on the card unless ``--device
cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from reporter_tpu_torch import (  # noqa: E402
    CompilerParams,
    Config,
    SegmentMatcher,
    Trace,
    compile_network,
    generate_city,
    make_app,
    make_router,
)
from reporter_tpu_torch.netgen.traces import (  # noqa: E402
    synthesize_fleet,
    synthesize_probe,
)
from reporter_tpu_torch.parallel import make_mesh  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device the four-shard mesh repeats "
                         "(default cuda)")
    args = ap.parse_args(argv)
    devices = [args.device] * 4
    print(f"devices: {len(devices)} × {args.device}")

    ts = compile_network(generate_city("tiny"),
                         CompilerParams(osmlr_max_length=200.0))

    # 1. mesh-sharded matcher: same API, rows split over ("tile", "dp")
    mesh = make_mesh(tile=2, dp=2, devices=devices)
    fleet = synthesize_fleet(ts, 13, num_points=60, seed=1)   # odd B:
    traces = [Trace(uuid=p.uuid, xy=p.xy.astype("float32"),  # row padding
                    times=p.times) for p in fleet]
    sharded = SegmentMatcher(ts, Config(), mesh=mesh)
    single = SegmentMatcher(ts, Config(), device=args.device)
    b_mesh = sharded.match_many(traces)
    b_one = single.match_many(traces)
    same = all(np.array_equal(getattr(b_mesh.columns, f),
                              getattr(b_one.columns, f))
               for f in b_one.columns._fields)
    print(f"match_many over {mesh.shape}: {b_mesh.n_records} records, "
          f"bit-identical to single-device: {same}")
    assert same

    # 2. the serving layer on the mesh
    app = make_app(ts, Config(), transport=lambda url, body: 200, mesh=mesh)
    out = app.report_one(synthesize_probe(ts, seed=3, num_points=40,
                                          gps_sigma=3.0).to_report_json())
    print(f"mesh-backed /report: {len(out['segments'])} segments")
    app.close()

    # 3. config 4: two metros, each on its own 2-device submesh
    metro_b = compile_network(generate_city("nyc", nx=8, ny=8),
                              CompilerParams(osmlr_max_length=200.0))
    router = make_router(
        [ts, metro_b], Config(), transport=lambda url, body: 200,
        meshes={ts.name: make_mesh(tile=1, dp=2, devices=devices[:2]),
                metro_b.name: make_mesh(tile=1, dp=2, devices=devices[2:])})
    results = router.report_many(
        [synthesize_probe(t, seed=s, num_points=40,
                          gps_sigma=3.0).to_report_json()
         for t in (ts, metro_b) for s in range(2)])
    by_metro = sorted({r["metro"] for r in results})
    print(f"MetroRouter over submeshes: {len(results)} requests "
          f"routed to {by_metro}")
    assert by_metro == sorted([ts.name, metro_b.name])
    router.close()


if __name__ == "__main__":
    main()
