"""The whole slice: the port's SegmentMatcher (plain PyTorch path on the
CPU) against the JAX package's, record for record (``to_json()``,
tolerance 0), on the golden fixtures and on a synthesized fleet.

The JAX matcher runs ``candidate_backend="dense"``: on a CPU backend
"auto" would resolve to the grid backend, and dense reaches _dense_jnp,
the plain reference of the Pallas sweep. On the golden tile its tables
go to the port as numpy arrays (``TileSet.from_arrays`` /
``tables_from_numpy``); the irregular tile each package parses from the
OSM XML fixture and compiles itself.
"""

import json
import os

import numpy as np
import pytest
import torch

from reporter_tpu.config import CompilerParams, Config, MatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.device import resolve_device
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    with open(os.path.join(_FIX, name)) as f:
        return json.load(f)


def _pair(jts):
    """(JAX matcher, port matcher on the same tile arrays, CPU)."""
    jm = JSegmentMatcher(jts, Config(
        matcher_backend="jax",
        matcher=MatcherParams(candidate_backend="dense")))
    arrays = {f: getattr(jts, f) for f in _ARRAY_FIELDS}
    ts = TileSet.from_arrays(jts.name, jts.meta.origin_lonlat, arrays)
    return jm, SegmentMatcher(ts, device="cpu")


@pytest.fixture(scope="module")
def golden():
    fx = _load("golden_traces.json")
    jts = compile_network(generate_city(fx[0]["city"]),
                          CompilerParams(**fx[0]["compiler"]))
    return (*_pair(jts), jts)


@pytest.fixture(scope="module")
def irregular():
    """(JAX matcher, port matcher), each on its own parse and compile of
    the fixture."""
    from reporter_tpu.netgen.osm_xml import parse_osm_xml
    from reporter_tpu_torch.config import CompilerParams as PCompilerParams
    from reporter_tpu_torch.netgen.osm_xml import (
        parse_osm_xml as p_parse_osm_xml)
    from reporter_tpu_torch.tiles.compiler import (
        compile_network as p_compile_network)

    kw = _load("golden_irregular.json")[0]["compiler"]
    osm = os.path.join(_FIX, "irregular.osm")
    jm, _ = _pair(compile_network(parse_osm_xml(osm, name="irregular"),
                                  CompilerParams(**kw)))
    ts = p_compile_network(p_parse_osm_xml(osm, name="irregular"),
                           PCompilerParams(**kw))
    return jm, SegmentMatcher(ts, device="cpu")


@pytest.mark.parametrize("fx", _load("golden_traces.json"),
                         ids=lambda f: f["name"])
def test_golden_records_equal(golden, fx):
    jm, m, _ = golden
    got = m.match(fx["request"])
    assert got == jm.match(fx["request"])
    assert [s["segment_id"] for s in got["segments"]] == fx["expected_segment_ids"]
    assert [s["way_ids"] for s in got["segments"]] == fx["expected_way_ids"]


@pytest.mark.parametrize("fx", _load("golden_irregular.json"),
                         ids=lambda f: f["name"])
def test_irregular_records_equal(irregular, fx):
    jm, m = irregular
    got = m.match(fx["request"])
    assert got == jm.match(fx["request"])
    assert [s["segment_id"] for s in got["segments"]] == fx["expected_segment_ids"]


def test_fleet_match_many_records_equal(golden):
    """64 synthesized traces of mixed lengths (two length buckets, a
    trace past the largest bucket split into chunks, one with per-point
    accuracy) through match_many."""
    jm, m, jts = golden
    fleet = synthesize_fleet(jts, 64, num_points=100, seed=5)
    traces = [JTrace(uuid=p.uuid, xy=p.xy.astype(np.float32), times=p.times)
              for p in fleet]
    traces[3] = JTrace(uuid="short", xy=traces[3].xy[:20],
                       times=traces[3].times[:20])
    long = np.concatenate([traces[4].xy] * 11)          # 1100 points
    traces[4] = JTrace(uuid="long", xy=long,
                       times=np.arange(len(long), dtype=np.float64))
    traces[5] = JTrace(uuid="acc", xy=traces[5].xy, times=traces[5].times,
                       accuracy=np.linspace(2.0, 20.0, 100).astype(np.float32))
    ref = jm.match_many(traces)
    before = m.point_counts["points"]
    got = m.match_many([Trace(t.uuid, t.xy, t.times, t.accuracy)
                        for t in traces])
    assert len(got) == len(ref) == 64
    for i, (g, r) in enumerate(zip(got, ref)):
        assert [x.to_json() for x in g] == [x.to_json() for x in r], i
    assert sum(len(g) for g in got) > 300
    assert (m.point_counts["points"] - before
            == sum(len(t.xy) for t in traces))


def test_device_is_cuda_unless_cpu_is_asked(golden):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            SegmentMatcher(golden[1].ts)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
