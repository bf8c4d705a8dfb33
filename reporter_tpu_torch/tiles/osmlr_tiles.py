"""Binary OSMLR segment tiles: the compact protobuf-wire publication format.

Counterpart: reporter_tpu/tiles/osmlr_tiles.py; the file is the JAX
package's, byte for byte, for the same tile, and each package reads the
other's. GeoJSON (tiles/osmlr_export.py) serves GIS consumers; this is
the machine format, written with the protobuf wire primitives of the
OSM PBF codec (netgen/pbf.py: varints, zigzag, length-delimited fields;
no protobuf dependency).

Message shape (field numbers, all length-delimited unless noted):

  Tile:    1 name (string)   2 repeated Segment
  Segment: 1 id (varint)     2 length_cm (varint)
           3 packed way_ids (zigzag delta)
           4 packed lons 1e-7 deg (zigzag delta)   5 packed lats (same)

Delta-coded fixed-point coordinates make a segment's geometry a few
bytes per point. The round trip is exact at 1e-7 degrees (~1 cm):
read_osmlr_tile returns what write_osmlr_tile wrote.
"""

from __future__ import annotations

from reporter_tpu_torch.netgen.pbf import (_delta_decode, _field, _fields,
                                           _ld, _packed, _packed_varints,
                                           _read_varint, _varint)
from reporter_tpu_torch.tiles.osmlr_export import osmlr_features
from reporter_tpu_torch.tiles.tileset import TileSet

_MAGIC = b"OSMLRT01"          # file magic + format version
_COORD_SCALE = 1e7            # 1e-7 deg fixed point (~1 cm)


def write_osmlr_tile(ts: TileSet, path: str) -> int:
    """Serialize the tileset's OSMLR segments; returns the segment count.

    Geometry and way membership come from osmlr_features, the stitching
    the GeoJSON export publishes, so the two formats agree on every
    segment's shape."""
    segments = []
    for feat in osmlr_features(ts):
        props = feat["properties"]
        lons = [int(round(lo * _COORD_SCALE))
                for lo, _ in feat["geometry"]["coordinates"]]
        lats = [int(round(la * _COORD_SCALE))
                for _, la in feat["geometry"]["coordinates"]]
        body = (_field(1, 0, _varint(int(feat["id"])))
                + _field(2, 0, _varint(int(round(
                    props["length_m"] * 100))))
                + _packed(3, props["way_ids"], signed=True, delta=True)
                + _packed(4, lons, signed=True, delta=True)
                + _packed(5, lats, signed=True, delta=True))
        segments.append(_ld(2, body))
    payload = _ld(1, ts.name.encode()) + b"".join(segments)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_varint(len(payload)))
        f.write(payload)
    return len(segments)


def read_osmlr_tile(path: str) -> dict:
    """Parse a tile written by write_osmlr_tile →
    {"name": ..., "segments": [{"id", "length_m", "way_ids",
    "coordinates": [(lon, lat)...]}, ...]}."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not an OSMLR tile (bad magic)")
    n, i = _read_varint(blob, len(_MAGIC))
    payload = blob[i:i + n]
    if len(payload) != n:
        # a short slice would parse into a partial tile without a word
        raise ValueError(f"{path}: truncated OSMLR tile "
                         f"({len(payload)} of {n} payload bytes)")
    name = ""
    segments = []
    for no, wt, v in _fields(payload):
        if no == 1 and wt == 2:
            name = v.decode()
        elif no == 2 and wt == 2:
            seg: dict = {"way_ids": [], "coordinates": []}
            lons = lats = None
            for sno, swt, sv in _fields(v):
                if sno == 1 and swt == 0:
                    seg["id"] = sv
                elif sno == 2 and swt == 0:
                    seg["length_m"] = sv / 100.0
                elif sno == 3 and swt == 2:
                    seg["way_ids"] = _delta_decode(
                        _packed_varints(sv, signed=True))
                elif sno == 4 and swt == 2:
                    lons = _delta_decode(_packed_varints(sv, signed=True))
                elif sno == 5 and swt == 2:
                    lats = _delta_decode(_packed_varints(sv, signed=True))
            if lons is not None and lats is not None:
                seg["coordinates"] = [
                    (lo / _COORD_SCALE, la / _COORD_SCALE)
                    for lo, la in zip(lons, lats)]
            segments.append(seg)
    return {"name": name, "segments": segments}
