"""The exact-Dijkstra oracle (reporter_tpu_torch/matcher/cpu_reference.py)
and the ``reference_cpu`` matcher against the JAX package's, and the
port's device path against the port's oracle.

Both oracles are float64 numpy on the host, so every comparison here is
exact (tolerance 0): candidates, Dijkstra labels, routes, per-point
matches and records (``to_json()``). The agreement gate mirrors
tests/test_golden.py's: length-weighted agreement >= 0.95 between the
device path (the port's on the CPU, the JAX package's dense path) and the
oracle, on the irregular fixture's 12-trace fleet; the port's pair must
give the JAX pair's number exactly.
"""

import json
import os

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams, Config, MatcherParams
from reporter_tpu.matcher import cpu_reference as jref
from reporter_tpu.matcher import fidelity as jfidelity
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from reporter_tpu_torch.config import Config as PConfig
from reporter_tpu_torch.config import MatcherParams as PMatcherParams
from reporter_tpu_torch.matcher import cpu_reference as ref
from reporter_tpu_torch.matcher import fidelity
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.tiles.tileset import TileSet
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    with open(os.path.join(_FIX, name)) as f:
        return json.load(f)


def _port_tile(jts):
    return TileSet.from_arrays(jts.name, jts.meta.origin_lonlat,
                               {f: getattr(jts, f) for f in _ARRAY_FIELDS})


@pytest.fixture(scope="module")
def golden():
    fx = _load("golden_traces.json")
    jts = compile_network(generate_city(fx[0]["city"]),
                          CompilerParams(**fx[0]["compiler"]))
    return jts, _port_tile(jts)


@pytest.fixture(scope="module")
def irregular():
    """(JAX tile, port tile), each package parsing and compiling the
    fixture itself."""
    from reporter_tpu.netgen.osm_xml import parse_osm_xml
    from reporter_tpu_torch.config import CompilerParams as PCompilerParams
    from reporter_tpu_torch.netgen.osm_xml import (
        parse_osm_xml as p_parse_osm_xml)
    from reporter_tpu_torch.tiles.compiler import (
        compile_network as p_compile_network)

    kw = _load("golden_irregular.json")[0]["compiler"]
    osm = os.path.join(_FIX, "irregular.osm")
    return (compile_network(parse_osm_xml(osm, name="irregular"),
                            CompilerParams(**kw)),
            p_compile_network(p_parse_osm_xml(osm, name="irregular"),
                              PCompilerParams(**kw)))


def _points(jts, n, seed):
    """Seeded points near the tile's edges, some off the network."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, len(jts.seg_a), n)
    t = rng.uniform(0.0, 1.0, (n, 1))
    base = jts.seg_a[s] + t * (jts.seg_b[s] - jts.seg_a[s])
    return (base + rng.normal(0.0, 15.0, (n, 2))).astype(np.float64)


def test_candidates_equal(golden):
    jts, ts = golden
    p, jp = PMatcherParams(), MatcherParams()
    for pt in _points(jts, 64, 1):
        got = ref.find_candidates_cpu(ts, pt, p)
        want = jref.find_candidates_cpu(jts, pt, jp)
        assert [(c.edge, c.offset, c.dist) for c in got] == \
            [(c.edge, c.offset, c.dist) for c in want]


def test_dijkstra_walk_and_route_equal(golden):
    jts, ts = golden
    rng = np.random.default_rng(2)
    for e in rng.integers(0, jts.num_edges, 24):
        e = int(e)
        for bound in (50.0, 400.0, 2500.0):
            got = ref.edge_dijkstra(ts, e, bound)
            assert got == jref.edge_dijkstra(jts, e, bound)
            for e2 in list(got)[:8]:
                assert ref.walk_prev(got, e2) == jref.walk_prev(got, e2)
        e2 = int(rng.integers(0, jts.num_edges))
        for o1, o2 in ((0.0, 3.0), (12.5, 1.0), (7.0, 7.0)):
            assert ref.route_between(ts, e, o1, e2, o2, 2500.0, 10.0) == \
                jref.route_between(jts, e, o1, e2, o2, 2500.0, 10.0)
        assert ref.route_between(ts, e, 9.0, e, 5.0, 800.0, 10.0) == \
            jref.route_between(jts, e, 9.0, e, 5.0, 800.0, 10.0)
    for gc in (0.0, 17.5, 1999.0):
        assert ref.viterbi_bound(gc, PMatcherParams()) == \
            jref.viterbi_bound(gc, MatcherParams())


def test_dijkstra_cache_equal(golden):
    """Same hits, searches and labels on the same call sequence
    (growing bounds, a reuse, eviction at a small capacity)."""
    jts, ts = golden
    c, jc = ref.DijkstraCache(max_edges=6), jref.DijkstraCache(max_edges=6)
    rng = np.random.default_rng(3)
    for e, bound in zip(rng.integers(0, jts.num_edges, 40),
                        rng.uniform(10.0, 900.0, 40)):
        assert c.reached(ts, int(e), float(bound)) == \
            jc.reached(jts, int(e), float(bound))
    assert (c.hits, c.searches, list(c._d)) == \
        (jc.hits, jc.searches, list(jc._d))


def test_interpolation_keep_and_match_trace_equal(golden):
    jts, ts = golden
    fleet = synthesize_fleet(jts, 6, num_points=60, seed=4)
    for i, pr in enumerate(fleet):
        xy = pr.xy.astype(np.float64)
        for d in (0.0, 10.0, 35.0):
            assert ref.interpolation_keep(xy, d) == \
                jref.interpolation_keep(xy, d)
        acc = (None if i % 2 else
               np.linspace(2.0, 25.0, len(xy)).astype(np.float32))
        assert ref.match_trace_cpu(ts, xy, PMatcherParams(), accuracy=acc) \
            == jref.match_trace_cpu(jts, xy, MatcherParams(), accuracy=acc)


@pytest.mark.parametrize("fx", _load("golden_traces.json"),
                         ids=lambda f: f["name"])
def test_oracle_golden_records_equal(golden, fx):
    jts, ts = golden
    got = SegmentMatcher(ts, PConfig(matcher_backend="reference_cpu")
                         ).match(fx["request"])
    want = JSegmentMatcher(jts, Config(matcher_backend="reference_cpu")
                           ).match(fx["request"])
    assert got == want
    assert [s["segment_id"] for s in got["segments"]] == \
        fx["expected_segment_ids"]


@pytest.mark.parametrize("fx", _load("golden_irregular.json"),
                         ids=lambda f: f["name"])
def test_oracle_irregular_records_equal(irregular, fx):
    jts, ts = irregular
    got = SegmentMatcher(ts, PConfig(matcher_backend="reference_cpu")
                         ).match(fx["request"])
    want = JSegmentMatcher(jts, Config(matcher_backend="reference_cpu")
                           ).match(fx["request"])
    assert got == want
    assert [s["segment_id"] for s in got["segments"]] == \
        fx["expected_segment_ids"]


def test_oracle_matcher_is_host_only(golden):
    """No device and no tables: the oracle needs no card to construct."""
    _, ts = golden
    m = SegmentMatcher(ts, PConfig(matcher_backend="reference_cpu"))
    assert m.backend == "reference_cpu" and m.tables is None
    assert m.device.type == "cpu"
    assert m.prepare_many([Trace("a", ts.seg_a[:4].astype(np.float32),
                                 np.arange(4.0))] * 2) is None
    with pytest.raises(NotImplementedError, match="device path"):
        m.matched_points(Trace("a", ts.seg_a[:4].astype(np.float32),
                               np.arange(4.0)))


def test_irregular_fleet_agreement_equals_the_jax_pair(irregular):
    """tests/test_golden.py's fleet gate on the port: the port's device
    path (CPU) against the port's oracle clears 0.95, with the records
    and the agreement of the JAX pair exactly."""
    jts, ts = irregular
    fleet = synthesize_fleet(jts, 12, num_points=80, seed=3)
    jtraces = [JTrace(uuid=p.uuid, xy=p.xy.astype("float32"), times=p.times)
               for p in fleet]
    traces = [Trace(t.uuid, t.xy, t.times) for t in jtraces]
    j_dev = JSegmentMatcher(jts, Config(
        matcher_backend="jax",
        matcher=MatcherParams(candidate_backend="dense"))).match_many(jtraces)
    j_ref = JSegmentMatcher(jts, Config(matcher_backend="reference_cpu")
                            ).match_many(jtraces)
    p_dev = SegmentMatcher(ts, device="cpu").match_many(traces)
    p_ref = SegmentMatcher(ts, PConfig(matcher_backend="reference_cpu")
                           ).match_many(traces)
    for got, want in ((p_ref, j_ref), (p_dev, j_dev)):
        assert [[r.to_json() for r in x] for x in got] == \
            [[r.to_json() for r in x] for x in want]
    agree, total = fidelity.length_weighted_agreement(p_dev, p_ref)
    assert agree / total >= 0.95, f"{agree:.1f}/{total:.1f}"
    assert (agree, total) == jfidelity.length_weighted_agreement(j_dev, j_ref)
    assert fidelity.mean_disagreement(p_dev, p_ref) == \
        jfidelity.mean_disagreement(j_dev, j_ref)


def test_fidelity_counts_empty_traces_as_agreement():
    class R:
        def __init__(self, s, n):
            self.segment_id, self.length = s, n

    a = [[], [R(1, 10.0), R(2, 5.0)], [R(3, 4.0)]]
    b = [[], [R(1, 8.0)], [R(4, 4.0)]]
    assert fidelity.length_weighted_agreement(a, b) == \
        jfidelity.length_weighted_agreement(a, b) == (9.0, 20.0)
    assert fidelity.mean_disagreement(a, b) == \
        jfidelity.mean_disagreement(a, b)
