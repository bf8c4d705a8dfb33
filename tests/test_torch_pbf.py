"""The port's OSM PBF reader and writer (reporter_tpu_torch/netgen/pbf.py)
against the JAX package's, at tolerance 0: the writer's bytes, each
package parsing the other's file, a PBF extract compiling to the same
tile as its XML form, and the same errors.

Fixtures: tests/fixtures/irregular.osm (ramps, dual carriageways,
curves; 7-decimal coordinates, exact on the PBF grid) and small element
sets of tests/test_pbf.py (custom granularity, 2^40-scale ids, the
southern and western hemispheres).
"""

import os
import warnings

import numpy as np
import pytest

from reporter_tpu.netgen import pbf as jpbf
from reporter_tpu.netgen.osm_xml import xml_elements
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.netgen import pbf
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS

from fixtures import adversarial_osm

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "irregular.osm")
BIG = 1 << 40
_SMALL = {
    "granularity": ({1: (-122.414100, 37.750000),
                     2: (-122.413200, 37.750100),
                     3: (-122.412300, 37.750200)},
                    [(7, [1, 2, 3], {"highway": "residential"})], [],
                    dict(granularity=1000)),
    "big_ids": ({BIG + 5: (0.001, 0.001), BIG + 1: (0.002, 0.001),
                 BIG + 9: (0.002, 0.002), BIG + 2: (0.001, 0.002)},
                [(BIG + 77, [BIG + 5, BIG + 1, BIG + 9, BIG + 2],
                  {"highway": "residential", "oneway": "yes"})], [], {}),
    "south_west": ({1: (-70.6506000, -33.4372000),
                    2: (-70.6505000, -33.4371000),
                    3: (-70.6504000, -33.4370000)},
                   [(3, [1, 2, 3], {"highway": "primary"})], [],
                   dict(compress=False)),
}


def _elements(case):
    if case == "irregular":
        return (*xml_elements(FIXTURE), {})
    if case == "adversarial":
        return (*adversarial_osm.build_elements(), {})
    return _SMALL[case]


CASES = ["irregular", "adversarial", *_SMALL]


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_net(a, b):
    assert _same(a.node_lonlat, b.node_lonlat)
    assert [(w.way_id, w.nodes, w.oneway, w.name, w.speed_mps,
             w.access_mask, sorted(w.geometry)) for w in a.ways] == \
        [(w.way_id, w.nodes, w.oneway, w.name, w.speed_mps, w.access_mask,
          sorted(w.geometry)) for w in b.ways]
    for wa, wb in zip(a.ways, b.ways):
        for leg in wa.geometry:
            assert _same(wa.geometry[leg], wb.geometry[leg])
    assert [(r.from_way, r.via_node, r.to_way, r.kind)
            for r in a.restrictions] == \
        [(r.from_way, r.via_node, r.to_way, r.kind) for r in b.restrictions]


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.mark.parametrize("case", CASES)
def test_writer_bytes_equal_reference(case, tmp_path):
    node_pos, ways, rels, kw = _elements(case)
    a, b = str(tmp_path / "port.pbf"), str(tmp_path / "jax.pbf")
    pbf.write_osm_pbf(a, node_pos, ways, rels, **kw)
    jpbf.write_osm_pbf(b, node_pos, ways, rels, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("case", CASES)
def test_each_package_parses_the_others_file(case, tmp_path):
    node_pos, ways, rels, kw = _elements(case)
    a, b = str(tmp_path / "port.pbf"), str(tmp_path / "jax.pbf")
    pbf.write_osm_pbf(a, node_pos, ways, rels, **kw)
    jpbf.write_osm_pbf(b, node_pos, ways, rels, **kw)
    for path in (a, b):
        _same_net(_quiet(pbf.parse_osm_pbf, path, name="x"),
                  _quiet(jpbf.parse_osm_pbf, path, name="x"))


@pytest.mark.parametrize("case", ["irregular", "adversarial"])
def test_pbf_compiles_as_xml(case, tmp_path):
    """The PBF form compiles to the XML form's tile: every array equal,
    except that the reader's decode, 1e-9 * (offset + granularity * raw)
    in both packages, lands up to 1e-12 degrees (tests/test_pbf.py's
    bound) off the XML's decimal parse; a segment coordinate may then
    move by that (1.2e-7 m) plus one f32 rounding. On irregular.osm one
    coordinate of seg_a and seg_b does."""
    node_pos, ways, rels, kw = _elements(case)
    path = str(tmp_path / "x.pbf")
    pbf.write_osm_pbf(path, node_pos, ways, rels, **kw)
    from reporter_tpu_torch.netgen.osm_xml import build_network

    cp = CompilerParams(reach_radius=400.0)
    want = _quiet(compile_network, _quiet(build_network, node_pos, ways, rels,
                                          name="x"), cp, mode="auto")
    got = _quiet(compile_network, _quiet(pbf.parse_osm_pbf, path, name="x"),
                 cp, mode="auto")
    for f in ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if f in ("seg_a", "seg_b"):
            assert a.shape == b.shape and np.all(
                np.abs(a - b) <= 1.2e-7 + np.spacing(np.abs(b))), f
        else:
            assert _same(a, b), f


def test_pbf_compile_equals_reference_compile(tmp_path):
    """The adversarial extract (restriction relations, non-drivable ways)
    as PBF: the port's parse and compile equal the JAX package's, array
    for array."""
    from reporter_tpu.config import CompilerParams as JCompilerParams
    from reporter_tpu.tiles.compiler import compile_network as j_compile

    path = str(tmp_path / "adv.pbf")
    pbf.write_osm_pbf(path, *adversarial_osm.build_elements())
    ts = _quiet(compile_network, _quiet(pbf.parse_osm_pbf, path, name="a"),
                CompilerParams(reach_radius=600.0), mode="auto")
    jts = _quiet(j_compile, _quiet(jpbf.parse_osm_pbf, path, name="a"),
                 JCompilerParams(reach_radius=600.0, use_native=False),
                 mode="auto")
    bad = [f for f in ARRAY_FIELDS if not _same(getattr(ts, f),
                                                getattr(jts, f))]
    assert not bad, bad
    assert len(ts.ban_set) >= 1


def test_unsupported_required_feature_raises_as_reference(tmp_path):
    path = str(tmp_path / "hist.pbf")
    with open(path, "wb") as f:
        pbf._write_blob(f, "OSMHeader", pbf._ld(4, b"HistoricalInformation"),
                        compress=True)
    with pytest.raises(ValueError) as got:
        pbf.parse_osm_pbf(path)
    with pytest.raises(ValueError) as want:
        jpbf.parse_osm_pbf(path)
    assert str(got.value) == str(want.value)
    assert "required feature" in str(got.value)


def test_other_errors_as_reference(tmp_path):
    """A negative varint, a blob with no payload and an unknown wire type
    raise the same errors in both packages."""
    for mod in (pbf, jpbf):
        with pytest.raises(ValueError, match="zigzag"):
            mod._varint(-1)
    path = str(tmp_path / "empty_blob.pbf")
    # a blob with neither a raw nor a zlib_data field
    header = pbf._ld(1, b"OSMData") + pbf._field(3, 0, pbf._varint(0))
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(4, "big") + header)
    msgs = []
    for mod in (pbf, jpbf):
        with pytest.raises(ValueError) as err:
            mod.parse_osm_pbf(path)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "neither raw nor zlib_data" in msgs[0]
    for mod in (pbf, jpbf):
        with pytest.raises(ValueError, match="wire type 3"):
            list(mod._fields(bytes([0x0B])))


def test_unknown_blob_type_is_skipped(tmp_path):
    node_pos = {1: (0.001, 0.001), 2: (0.002, 0.002)}
    ways = [(1, [1, 2], {"highway": "residential"})]
    path = str(tmp_path / "extra.pbf")
    pbf.write_osm_pbf(path, node_pos, ways)
    with open(path, "ab") as f:
        pbf._write_blob(f, "SomeVendorExtension", b"\x08\x01", compress=False)
    _same_net(pbf.parse_osm_pbf(path), jpbf.parse_osm_pbf(path))
    assert len(pbf.parse_osm_pbf(path).ways) == 1
