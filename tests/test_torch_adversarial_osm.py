"""The adversarial OSM extract (tests/fixtures/adversarial_osm.py:
restriction relations valid and degenerate, non-drivable ways,
self-loops, coincident and dangling refs, out-of-range coordinates)
through both packages, from XML and from PBF: the networks, every array
of the compiled tiles and the warnings are the same, at tolerance 0. The
port matches a fleet on it, and its oracle agrees with the JAX one."""

import warnings

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config as JConfig
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.osm_xml import parse_osm_xml as j_parse_osm_xml
from reporter_tpu.netgen.pbf import parse_osm_pbf as j_parse_osm_pbf
from reporter_tpu.tiles.compiler import compile_network as j_compile
from reporter_tpu_torch.config import CompilerParams, Config
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen.osm_xml import parse_osm_xml
from reporter_tpu_torch.netgen.pbf import parse_osm_pbf, write_osm_pbf
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS
from _torch_support import few_torch_threads  # noqa: F401

from fixtures import adversarial_osm

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _caught(fn, *a, **kw):
    """(fn's result, the messages of the warnings it raised)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    return out, [str(w.message) for w in got]


@pytest.fixture(scope="module")
def pbf_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("adv") / "adversarial.osm.pbf")
    write_osm_pbf(path, *adversarial_osm.build_elements())
    return path


def _parse(fmt, pkg, pbf_path):
    if fmt == "xml":
        fn = parse_osm_xml if pkg == "port" else j_parse_osm_xml
        return _caught(fn, adversarial_osm.as_xml(), name="adversarial")
    fn = parse_osm_pbf if pkg == "port" else j_parse_osm_pbf
    return _caught(fn, pbf_path, name="adversarial")


@pytest.mark.parametrize("fmt", ["xml", "pbf"])
def test_networks_and_warnings_equal(fmt, pbf_path):
    (net, w), (jnet, jw) = (_parse(fmt, p, pbf_path) for p in ("port", "jax"))
    assert w == jw and any("out-of-range" in m for m in w)
    assert _same(net.node_lonlat, jnet.node_lonlat)
    assert [(x.way_id, x.nodes, x.oneway, x.speed_mps, x.access_mask,
             sorted(x.geometry)) for x in net.ways] == \
        [(x.way_id, x.nodes, x.oneway, x.speed_mps, x.access_mask,
          sorted(x.geometry)) for x in jnet.ways]
    assert [(r.from_way, r.via_node, r.to_way, r.kind)
            for r in net.restrictions] == \
        [(r.from_way, r.via_node, r.to_way, r.kind)
         for r in jnet.restrictions] != []


@pytest.mark.parametrize("mode", [None, "auto", "bicycle", "foot"])
@pytest.mark.parametrize("fmt", ["xml", "pbf"])
def test_tiles_and_warnings_equal(fmt, mode, pbf_path):
    """Every array equal, the compile warnings (the mixed network's auto
    subgraph) the same; the XML and PBF forms compile alike."""
    (net, _), (jnet, _) = (_parse(fmt, p, pbf_path) for p in ("port", "jax"))
    ts, w = _caught(compile_network, net, CompilerParams(reach_radius=600.0),
                    mode=mode)
    jts, jw = _caught(j_compile, jnet, JCompilerParams(reach_radius=600.0,
                                                       use_native=False),
                      mode=mode)
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(ts, f),
                                                getattr(jts, f))]
    assert not bad, bad
    assert [m for m in w if "grid" not in m] == \
        [m for m in jw if "grid" not in m]
    assert (mode is None) == any("non-drivable" in m for m in w)
    assert bool(len(ts.ban_set)) == (mode != "foot")


def test_xml_and_pbf_compile_alike(pbf_path):
    tiles = [_caught(compile_network, _parse(fmt, "port", pbf_path)[0],
                     CompilerParams(reach_radius=600.0), mode="auto")[0]
             for fmt in ("xml", "pbf")]
    for f in ("edge_src", "edge_dst", "edge_way", "osmlr_id", "reach_to",
              "edge_reach_row", "ban_from", "ban_to"):
        assert _same(getattr(tiles[0], f), getattr(tiles[1], f)), f


def test_fleet_records_equal_reference(pbf_path):
    """A fleet driven on the auto tile: the port's records (its device
    path on the CPU and its oracle) equal the JAX package's."""
    net, _ = _parse("xml", "port", pbf_path)
    jnet, _ = _parse("xml", "jax", pbf_path)
    ts = compile_network(net, CompilerParams(reach_radius=600.0),
                         mode="auto")
    jts = j_compile(jnet, JCompilerParams(reach_radius=600.0), mode="auto")
    fleet = synthesize_fleet(ts, 6, num_points=40, seed=5, gps_sigma=3.0)
    traces = [Trace(p.uuid, p.xy.astype(np.float32), p.times) for p in fleet]
    jtraces = [JTrace(t.uuid, t.xy, t.times) for t in traces]
    for backend, jbackend in (("torch", "jax"),
                              ("reference_cpu", "reference_cpu")):
        got = SegmentMatcher(ts, Config(matcher_backend=backend),
                             device="cpu").match_many(traces)
        jm = JSegmentMatcher(jts, JConfig(matcher_backend=jbackend))
        want = jm.match_many(jtraces)
        assert [[r.to_json() for r in x] for x in got] == \
            [[r.to_json() for r in x] for x in want], backend
        assert sum(len(x) for x in got) > 0
