"""The port's irregular metros against the JAX package's: the organic
generator (netgen/organic.py) and the OSM XML parser (netgen/osm_xml.py),
network and compiled tile byte for byte; the plain candidates at the other
top-K widths against ``_dense_jnp``; and, on a small organic tile, how
often the port's candidates differ from XLA:CPU's, with the records held
equal.

Tolerance of the candidates: as tests/test_torch_dense_candidates.py
states for K = 8 (XLA:CPU fuses multiply-adds, the port rounds every
operation): per point the same edges except at a cut (within 1e-4 m of
the radius or of the K-th distance), per shared edge |Δdist| and
|Δoffset| ≤ 1e-3 m. On the small organic tile the shares of points whose
candidates differ in any bit, in their edge list and in their edge set
are printed with -s.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.config import Config, MatcherParams as JMatcherParams
from reporter_tpu.matcher.api import SegmentMatcher as JSegmentMatcher
from reporter_tpu.matcher.api import Trace as JTrace
from reporter_tpu.netgen.organic import (
    generate_organic_city as j_generate_organic_city)
from reporter_tpu.netgen.osm_xml import parse_osm_xml as j_parse_osm_xml
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops.dense_candidates import (
    find_candidates_dense as j_find_candidates_dense)
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
from reporter_tpu_torch.netgen.network import TurnRestriction
from reporter_tpu_torch.netgen.organic import generate_organic_city
from reporter_tpu_torch.netgen.osm_xml import parse_osm_xml
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.ops.dense_candidates import (build_seg_pack,
                                                     find_candidates_dense)
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")
_OSM = os.path.join(_FIX, "irregular.osm")
RADIUS = 50.0
CUT_TOL = 1e-4
FIELD_TOL = 1e-3
# a small organic city: the port's Python reach build stays within seconds
SMALL = dict(radius=1200.0, n_candidates=3000)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_network(a, b):
    assert a.name == b.name and _same(a.node_lonlat, b.node_lonlat)
    assert len(a.ways) == len(b.ways)
    for wa, wb in zip(a.ways, b.ways):
        assert (wa.way_id, wa.nodes, wa.oneway, wa.name, wa.speed_mps,
                wa.access_mask) == (wb.way_id, wb.nodes, wb.oneway, wb.name,
                                    wb.speed_mps, wb.access_mask)
        assert sorted(wa.geometry) == sorted(wb.geometry)
        for leg in wa.geometry:
            assert _same(wa.geometry[leg], wb.geometry[leg])
    assert [(r.from_way, r.via_node, r.to_way, r.kind)
            for r in a.restrictions] == \
        [(r.from_way, r.via_node, r.to_way, r.kind) for r in b.restrictions]


def _same_tile(ts, ref):
    bad = [f for f in ARRAY_FIELDS
           if not _same(getattr(ts, f), getattr(ref, f))]
    assert not bad, bad
    assert ts.meta.origin_lonlat == ref.meta.origin_lonlat


def test_organic_network_equals_reference():
    """generate_city("organic") (seed 11, the default sizes): every node's
    lon/lat and every way's fields equal the JAX package's."""
    _same_network(generate_city("organic"), j_generate_city("organic"))


def test_organic_names_check_their_arguments():
    for kw in (dict(center=(0.0, 0.0)), dict(nx=4), dict(p_oneway=0.5)):
        with pytest.raises(ValueError):
            generate_city("organic", **kw)
    with pytest.raises(ValueError):
        generate_city("organic-xl", spacing=100.0)


@pytest.fixture(scope="module")
def small_organic():
    """(port tile, JAX tile) of a small organic city."""
    ts = compile_network(generate_organic_city(**SMALL))
    ref = j_compile_network(j_generate_organic_city(**SMALL),
                            JCompilerParams(use_native=False))
    return ts, ref


def test_small_organic_tile_equals_reference(small_organic):
    _same_network(generate_organic_city(**SMALL),
                  j_generate_organic_city(**SMALL))
    _same_tile(*small_organic)


def test_irregular_osm_equals_reference():
    """parse_osm_xml of the fixture: the network and its compiled tile
    equal the JAX package's; a restriction relation parses to a
    TurnRestriction, and the restricted tile (banned pairs, private reach
    rows) equals the JAX package's too."""
    import json

    with open(os.path.join(_FIX, "golden_irregular.json")) as f:
        kw = json.load(f)[0]["compiler"]
    net = parse_osm_xml(_OSM, name="irregular")
    _same_network(net, j_parse_osm_xml(_OSM, name="irregular"))
    _same_tile(compile_network(net, CompilerParams(**kw)),
               j_compile_network(j_parse_osm_xml(_OSM, name="irregular"),
                                 JCompilerParams(use_native=False, **kw)))
    with open(_OSM) as f:
        doc = f.read()
    w = next(w for w in net.ways if not w.oneway)   # a U-turn to ban
    rel = (f'<relation id="9"><member type="way" ref="{w.way_id}" '
           f'role="from"/><member type="node" ref="{_via_ref(doc, w)}" '
           f'role="via"/><member type="way" ref="{w.way_id}" role="to"/>'
           '<tag k="type" v="restriction"/>'
           '<tag k="restriction" v="no_u_turn"/></relation>')
    doc = doc.replace("</osm>", rel + "</osm>")
    rnet = parse_osm_xml(doc, name="restricted")
    _same_network(rnet, j_parse_osm_xml(doc, name="restricted"))
    assert len(rnet.restrictions) == 1
    r = rnet.restrictions[0]
    assert isinstance(r, TurnRestriction) and not r.mandatory
    rts = compile_network(rnet, CompilerParams(**kw))
    _same_tile(rts, j_compile_network(j_parse_osm_xml(doc, name="restricted"),
                                      JCompilerParams(use_native=False, **kw)))
    assert rts.stats["banned_turn_pairs"] >= 1
    assert len(rts.reach_to) > rts.num_nodes


def _via_ref(doc: str, way) -> int:
    """The OSM id of ``way``'s last junction node, read from the XML."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(doc)
    for w in root.iter("way"):
        if int(w.get("id")) == way.way_id:
            return int(w.findall("nd")[-1].get("ref"))
    raise AssertionError(way.way_id)


def _candidates(ts, pts, k):
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    ref = j_find_candidates_dense(jnp.asarray(pts),
                                  (jnp.asarray(sp.pack), jnp.asarray(sp.bbox)),
                                  RADIUS, k)
    got = find_candidates_dense(torch.from_numpy(pts),
                                tuple(torch.from_numpy(x) for x in sp),
                                RADIUS, k)
    return ([np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
            [x.numpy() for x in (got.edge, got.offset, got.dist)])


def _assert_close(ref, got, k) -> dict:
    """The stated tolerance at top-K width k. → counts of points whose
    candidates differ: in any bit ("bits"), in their edge list ("edges":
    set or slot order), in their edge set ("sets")."""
    (je, jo, jd), (e, o, d) = ref, got
    assert e.shape[1] == k
    differ = {"bits": 0, "edges": 0, "sets": 0}
    for i in range(len(e)):
        a = {int(x): (jd[i, j], jo[i, j]) for j, x in enumerate(je[i]) if x >= 0}
        b = {int(x): (d[i, j], o[i, j]) for j, x in enumerate(e[i]) if x >= 0}
        for x in a.keys() & b.keys():
            assert abs(a[x][0] - b[x][0]) <= FIELD_TOL, (i, x)
            assert abs(a[x][1] - b[x][1]) <= FIELD_TOL, (i, x)
        for x in a.keys() ^ b.keys():
            dist = a[x][0] if x in a else b[x][0]
            other = b if x in a else a
            cut = max(v[0] for v in other.values()) if len(other) == k \
                else RADIUS
            assert min(abs(dist - RADIUS), abs(dist - cut)) <= CUT_TOL, (i, x)
        differ["sets"] += bool(a.keys() ^ b.keys())
        differ["edges"] += not np.array_equal(je[i], e[i])
        differ["bits"] += not (np.array_equal(je[i], e[i]) and
                               jo[i].tobytes() == o[i].tobytes() and
                               jd[i].tobytes() == d[i].tobytes())
    return differ


@pytest.mark.parametrize("k", [6, 12])
def test_plain_candidates_at_other_k(k):
    """The port's plain candidates at K = 6 and 12 against _dense_jnp, at
    the tolerance stated for K = 8, on a fleet and every node of a grid
    city."""
    from reporter_tpu_torch.netgen.traces import synthesize_fleet as fleet

    ts = compile_network(generate_city("tiny", seed=11))
    pts = np.concatenate([np.concatenate([p.xy for p in fleet(ts, 8,
                                                               seed=2)]),
                          ts.node_xy]).astype(np.float32)
    _assert_close(*_candidates(ts, pts, k), k)


def test_small_organic_candidates_and_records(small_organic):
    """On the small organic tile: candidates within the stated tolerance
    of XLA:CPU's (the share of points that differ at all printed), and the
    records of a 32-trace fleet equal the JAX matcher's."""
    ts, ref = small_organic
    fleet = synthesize_fleet(ref, 32, num_points=100, seed=3)
    pts = np.concatenate([p.xy for p in fleet]).astype(np.float32)
    differ = _assert_close(*_candidates(ts, pts, 8), 8)
    print(f"\nsmall organic, {len(pts)} points: differ from _dense_jnp " +
          ", ".join(f"in {w} {n} ({n / len(pts):.4%})"
                    for w, n in differ.items()))
    jm = JSegmentMatcher(ref, Config(
        matcher_backend="jax",
        matcher=JMatcherParams(candidate_backend="dense")))
    traces = [Trace(p.uuid, p.xy.astype(np.float32), p.times) for p in fleet]
    got = SegmentMatcher(ts, device="cpu").match_many(traces)
    want = jm.match_many([JTrace(t.uuid, t.xy, t.times) for t in traces])
    assert [[r.to_json() for r in x] for x in got] == \
        [[r.to_json() for r in x] for x in want]
    assert sum(len(x) for x in got) > 3 * len(traces)
