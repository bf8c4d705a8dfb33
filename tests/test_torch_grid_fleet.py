"""The port's grid matcher against the JAX package's grid matcher, both on
the CPU, record for record over a synthesized fleet of one metro.

The two grids rank a cell's segments differently where a K-th-place tie
exists in the rounded distance alone (the port by the squared distance,
as both dense sweeps do; ROADMAP queue 3), so their candidate sets can
differ at such points. This counts the traces whose records
(``to_json()``) differ, to show what that divergence does to records.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_grid_fleet.py \\
        [--city sf] [--traces 1024] [--points 120] [--seed 0] [--slice 128]

prints one JSON object. The fleet is the JAX package's synthesize_fleet
on its compile of the metro (the port's equals it, tests/test_torch_
netgen.py); both matchers read the same tile arrays. Traces go through
in slices of ``--slice`` to bound memory. Under pytest, a small fleet.
"""

import argparse
import json
import time

import numpy as np
import pytest
import torch
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)



def compare(city: str = "sf", n_traces: int = 1024, n_points: int = 120,
            seed: int = 0, slice_traces: int = 128) -> dict:
    from reporter_tpu.config import CompilerParams as JCompilerParams
    from reporter_tpu.config import Config as JConfig
    from reporter_tpu.config import MatcherParams as JMatcherParams
    from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
    from reporter_tpu.matcher.api import Trace as JTrace
    from reporter_tpu.netgen.synthetic import generate_city
    from reporter_tpu.netgen.traces import synthesize_fleet
    from reporter_tpu.tiles.compiler import compile_network
    from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.tiles.tileset import TileSet

    jts = compile_network(generate_city(city), JCompilerParams())
    ts = TileSet.from_arrays(jts.name, jts.meta,
                             {f: getattr(jts, f) for f in _ARRAY_FIELDS})
    jm = JSegmentMatcher(jts, JConfig(
        matcher_backend="jax",
        matcher=JMatcherParams(candidate_backend="grid")))
    pm = SegmentMatcher(ts, MatcherParams(candidate_backend="grid"),
                        device="cpu")
    fleet = synthesize_fleet(jts, n_traces, num_points=n_points, seed=seed)
    jtr = [JTrace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
           for p in fleet]
    ptr = [Trace(uuid=t.uuid, xy=t.xy, times=t.times) for t in jtr]
    differ, records, seconds = [], 0, {"jax": 0.0, "port": 0.0}
    for lo in range(0, n_traces, slice_traces):
        t0 = time.perf_counter()
        want = jm.match_many(jtr[lo:lo + slice_traces])
        t1 = time.perf_counter()
        got = pm.match_many(ptr[lo:lo + slice_traces])
        seconds["jax"] += t1 - t0
        seconds["port"] += time.perf_counter() - t1
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = [r.to_json() for r in g], [r.to_json() for r in w]
            records += len(w)
            if g != w:
                differ.append(lo + i)
    return {"city": city, "traces": n_traces, "points": n_points,
            "seed": seed, "records": records,
            "traces_differing": len(differ), "differing": differ[:32],
            "seconds": seconds}


@pytest.mark.usefixtures("few_torch_threads")
def test_grid_records_equal_the_jax_grid_on_a_fleet():
    """A small fleet (tiny, 32 x 60, seed 0): every trace's records equal
    the JAX grid matcher's, as on sf's whole 1024 x 120 fleet (seed 0,
    8,712 records, 0 traces differ; PERF.md section 7)."""
    out = compare("tiny", 32, 60, 0, 32)
    assert out["records"] > 100
    assert out["traces_differing"] == 0, out["differing"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--city", default="sf")
    ap.add_argument("--traces", type=int, default=1024)
    ap.add_argument("--points", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slice", type=int, default=128)
    a = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    print(json.dumps(compare(a.city, a.traces, a.points, a.seed, a.slice)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
