"""The port's OSMLR exports (tiles/osmlr_export.py, tiles/osmlr_tiles.py)
against the JAX package's (reporter_tpu) on the same tiles: the GeoJSON
file and the binary tile byte for byte (tolerance 0), each package
reading the other's tile, and the round trip of tests/test_osmlr_tiles.py.
"""

import json

import numpy as np
import pytest

from reporter_tpu.config import CompilerParams as JCompilerParams
from reporter_tpu.netgen.synthetic import (
    add_random_restrictions as j_add_random_restrictions)
from reporter_tpu.netgen.synthetic import (
    assign_mode_access as j_assign_mode_access)
from reporter_tpu.netgen.synthetic import generate_city as j_generate_city
from reporter_tpu.tiles.compiler import compile_network as j_compile_network
from reporter_tpu.tiles.osmlr_export import \
    export_osmlr_geojson as j_export_osmlr_geojson
from reporter_tpu.tiles.osmlr_export import osmlr_features as j_osmlr_features
from reporter_tpu.tiles.osmlr_tiles import read_osmlr_tile as j_read_osmlr_tile
from reporter_tpu.tiles.osmlr_tiles import \
    write_osmlr_tile as j_write_osmlr_tile
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS as J_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.tiles.osmlr_export import (export_osmlr_geojson,
                                                   osmlr_features)
from reporter_tpu_torch.tiles.osmlr_tiles import (_COORD_SCALE,
                                                  read_osmlr_tile,
                                                  write_osmlr_tile)
from reporter_tpu_torch.tiles.tileset import TileSet

_CASES = {
    "tiny": lambda: j_compile_network(
        j_generate_city("tiny"), JCompilerParams(osmlr_max_length=250.0)),
    "sf": lambda: j_compile_network(j_generate_city("sf"), JCompilerParams()),
    "sf+r": lambda: j_compile_network(
        j_add_random_restrictions(j_generate_city("sf")), JCompilerParams()),
    "bicycle": lambda: j_compile_network(
        j_assign_mode_access(j_generate_city("tiny")), JCompilerParams(),
        mode="bicycle"),
}


@pytest.fixture(scope="module", params=sorted(_CASES))
def tiles(request):
    ref = _CASES[request.param]()
    return ref, TileSet.from_arrays(ref.name, ref.meta,
                                    {f: getattr(ref, f) for f in J_FIELDS})


def test_geojson_byte_equal(tiles, tmp_path):
    ref, ts = tiles
    a, b = str(tmp_path / "port.geojson"), str(tmp_path / "jax.geojson")
    n = export_osmlr_geojson(ts, a)
    assert n == j_export_osmlr_geojson(ref, b) > 0
    assert open(a, "rb").read() == open(b, "rb").read()
    assert osmlr_features(ts) == j_osmlr_features(ref)


def test_binary_tile_byte_equal_and_read_across(tiles, tmp_path):
    ref, ts = tiles
    a, b = str(tmp_path / "port.osmlr"), str(tmp_path / "jax.osmlr")
    assert write_osmlr_tile(ts, a) == j_write_osmlr_tile(ref, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert read_osmlr_tile(b) == j_read_osmlr_tile(a)


def test_round_trip(tiles, tmp_path):
    """tests/test_osmlr_tiles.py's round trip on the port: ids, lengths
    (to the centimetre), way ids and coordinates (1e-7 degrees) of every
    segment read back as the GeoJSON export has them."""
    _, ts = tiles
    path = str(tmp_path / "t.osmlr")
    n = write_osmlr_tile(ts, path)
    feats = osmlr_features(ts)
    tile = read_osmlr_tile(path)
    assert tile["name"] == ts.name and len(tile["segments"]) == n
    for seg, feat in zip(tile["segments"], feats):
        props = feat["properties"]
        assert seg["id"] == feat["id"]
        assert abs(seg["length_m"] - props["length_m"]) <= 0.005
        assert seg["way_ids"] == props["way_ids"]
        np.testing.assert_allclose(np.asarray(seg["coordinates"]),
                                   np.asarray(feat["geometry"]["coordinates"]),
                                   atol=1.5 / _COORD_SCALE, rtol=0)


@pytest.mark.parametrize("cut", ["magic", "truncated"])
def test_bad_tiles_rejected(tmp_path, cut):
    ref = _CASES["tiny"]()
    ts = TileSet.from_arrays(ref.name, ref.meta,
                             {f: getattr(ref, f) for f in J_FIELDS})
    path = str(tmp_path / "t.osmlr")
    write_osmlr_tile(ts, path)
    blob = open(path, "rb").read()
    bad = tmp_path / "bad.osmlr"
    bad.write_bytes(b"NOTATILE" + blob[8:] if cut == "magic"
                    else blob[:len(blob) // 2])
    with pytest.raises(ValueError, match=cut):
        read_osmlr_tile(str(bad))


def test_geojson_is_a_feature_collection(tmp_path):
    ref = _CASES["tiny"]()
    ts = TileSet.from_arrays(ref.name, ref.meta,
                             {f: getattr(ref, f) for f in J_FIELDS})
    path = str(tmp_path / "t.geojson")
    export_osmlr_geojson(ts, path)
    doc = json.load(open(path))
    assert doc["type"] == "FeatureCollection"
    assert doc["name"] == f"{ts.name}-osmlr"
    assert all(len(f["geometry"]["coordinates"]) >= 2
               for f in doc["features"])
