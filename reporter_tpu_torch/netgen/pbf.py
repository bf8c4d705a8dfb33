"""OSM PBF reader and writer → RoadNetwork, with no protobuf library.

Counterpart: reporter_tpu/netgen/pbf.py (``parse_osm_pbf``,
``write_osm_pbf``): the same blob framing, string table, granularity and
offsets, the same bytes written and the same errors. The format is
protobuf's wire format (varints, zigzag, length-delimited fields) over a
blob framing:

  file   := ( u32be len | BlobHeader | Blob )*
  BlobHeader := { 1: type "OSMHeader"|"OSMData", 3: datasize }
  Blob       := { 1: raw bytes | 3: zlib_data bytes, 2: raw_size }
  OSMHeader  → HeaderBlock { 4: required_features*, 5: optional_features* }
  OSMData    → PrimitiveBlock {
      1: stringtable { 1: bytes* },  2: PrimitiveGroup*,
      17: granularity (=100), 19: lat_offset (=0), 20: lon_offset (=0) }
  PrimitiveGroup := { 1: Node*, 2: DenseNodes, 3: Way*, 4: Relation* }
  DenseNodes := { 1: ids sint64 packed Δ, 8/9: lat/lon sint64 packed Δ,
                  10: keys_vals int32 packed (0-terminated per node) }
  Way        := { 1: id, 2/3: keys/vals uint32 packed, 8: refs sint64 packed Δ }
  Relation   := { 1: id, 2/3: keys/vals, 8: roles_sid packed,
                  9: memids sint64 packed Δ, 10: types packed (0/1/2) }

Coordinates decode as 1e-9 * (offset + granularity * raw) degrees. Both
this reader and the XML parser feed osm_xml.build_network, so a .pbf and
the equivalent .osm compile to the same tile. The writer takes element
sets (the shape ``osm_xml.xml_elements`` returns), not a RoadNetwork.
"""

from __future__ import annotations

import struct
import zlib

from reporter_tpu_torch.netgen.network import RoadNetwork
from reporter_tpu_torch.netgen.osm_xml import build_network

_MEMBER_TYPES = ("node", "way", "relation")   # Relation.MemberType enum


# ---- protobuf wire primitives ------------------------------------------


def _read_varint(buf: bytes, i: int) -> "tuple[int, int]":
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value): ints for wiretype 0, bytes for 2,
    raw u64/u32 for 1/5 (unused by OSM but skipped correctly)."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_varints(data: bytes, signed: bool = False) -> "list[int]":
    out, i = [], 0
    while i < len(data):
        v, i = _read_varint(data, i)
        out.append(_zigzag(v) if signed else v)
    return out


def _delta_decode(vals: "list[int]") -> "list[int]":
    acc, out = 0, []
    for v in vals:
        acc += v
        out.append(acc)
    return out


# ---- reader -------------------------------------------------------------


def _blob_payload(blob: bytes) -> bytes:
    raw = zdata = None
    for field, _, v in _fields(blob):
        if field == 1:
            raw = v
        elif field == 3:
            zdata = v
    if raw is not None:
        return raw
    if zdata is not None:
        return zlib.decompress(zdata)
    raise ValueError("Blob carries neither raw nor zlib_data "
                     "(lzma/zstd blobs unsupported)")


def _iter_blobs(path: str):
    with open(path, "rb") as f:
        while True:
            hdr_len = f.read(4)
            if len(hdr_len) < 4:
                return
            header = f.read(struct.unpack(">I", hdr_len)[0])
            btype, datasize = "", 0
            for field, _, v in _fields(header):
                if field == 1:
                    btype = v.decode()
                elif field == 3:
                    datasize = v
            yield btype, _blob_payload(f.read(datasize))


def _parse_dense(data: bytes, node_pos, gran, lat_off, lon_off):
    ids = lats = lons = ()
    for field, _, v in _fields(data):
        if field == 1:
            ids = _delta_decode(_packed_varints(v, signed=True))
        elif field == 8:
            lats = _delta_decode(_packed_varints(v, signed=True))
        elif field == 9:
            lons = _delta_decode(_packed_varints(v, signed=True))
    for nid, la, lo in zip(ids, lats, lons):
        node_pos[nid] = (1e-9 * (lon_off + gran * lo),
                         1e-9 * (lat_off + gran * la))


def _tags(keys, vals, strings) -> "dict[str, str]":
    return {strings[k]: strings[v] for k, v in zip(keys, vals)}


def parse_osm_pbf(path: str, name: str = "osm") -> RoadNetwork:
    """Parse an .osm.pbf file into a RoadNetwork (same graph as the XML
    parser produces for an equivalent extract)."""
    node_pos: dict[int, tuple[float, float]] = {}
    raw_ways: list = []
    raw_relations: list = []

    for btype, payload in _iter_blobs(path):
        if btype == "OSMHeader":
            for field, _, v in _fields(payload):
                if field == 4:            # required_features
                    feat = v.decode()
                    if feat not in ("OsmSchema-V0.6", "DenseNodes"):
                        raise ValueError(
                            f"unsupported required feature: {feat!r}")
            continue
        if btype != "OSMData":
            continue                      # per spec: skip unknown blob types

        strings: list[str] = []
        groups: list[bytes] = []
        gran, lat_off, lon_off = 100, 0, 0
        for field, _, v in _fields(payload):
            if field == 1:
                strings = [s.decode("utf-8")
                           for _, _, s in _fields(v)]
            elif field == 2:
                groups.append(v)
            elif field == 17:
                gran = v
            elif field == 19:
                lat_off = v
            elif field == 20:
                lon_off = v

        for group in groups:
            for field, _, v in _fields(group):
                if field == 2:            # DenseNodes
                    _parse_dense(v, node_pos, gran, lat_off, lon_off)
                elif field == 1:          # plain Node
                    nid = la = lo = 0
                    for f2, _, v2 in _fields(v):
                        if f2 == 1:
                            nid = _zigzag(v2)
                        elif f2 == 8:
                            la = _zigzag(v2)
                        elif f2 == 9:
                            lo = _zigzag(v2)
                    node_pos[nid] = (1e-9 * (lon_off + gran * lo),
                                     1e-9 * (lat_off + gran * la))
                elif field == 3:          # Way
                    wid, keys, vals, refs = 0, (), (), ()
                    for f2, _, v2 in _fields(v):
                        if f2 == 1:
                            wid = v2
                        elif f2 == 2:
                            keys = _packed_varints(v2)
                        elif f2 == 3:
                            vals = _packed_varints(v2)
                        elif f2 == 8:
                            refs = _delta_decode(
                                _packed_varints(v2, signed=True))
                    raw_ways.append((wid, list(refs),
                                     _tags(keys, vals, strings)))
                elif field == 4:          # Relation
                    keys, vals, roles, memids, types = (), (), (), (), ()
                    for f2, _, v2 in _fields(v):
                        if f2 == 2:
                            keys = _packed_varints(v2)
                        elif f2 == 3:
                            vals = _packed_varints(v2)
                        elif f2 == 8:
                            roles = _packed_varints(v2)
                        elif f2 == 9:
                            memids = _delta_decode(
                                _packed_varints(v2, signed=True))
                        elif f2 == 10:
                            types = _packed_varints(v2)
                    members = [(strings[r], _MEMBER_TYPES[t], m)
                               for r, m, t in zip(roles, memids, types)]
                    raw_relations.append((_tags(keys, vals, strings),
                                          members))

    return build_network(node_pos, raw_ways, raw_relations, name)


# ---- writer -------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        # Python's arbitrary-precision ints would loop forever below;
        # negative values must be zigzag-encoded by the caller.
        raise ValueError(f"negative varint {v}: field needs zigzag encoding")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_enc(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _field(no: int, wt: int, payload: bytes) -> bytes:
    return _varint(no << 3 | wt) + payload


def _ld(no: int, payload: bytes) -> bytes:          # length-delimited
    return _field(no, 2, _varint(len(payload)) + payload)


def _packed(no: int, vals, signed=False, delta=False) -> bytes:
    if not vals:
        return b""
    if delta:
        vals = [vals[0]] + [b - a for a, b in zip(vals, vals[1:])]
    body = b"".join(_varint(_zigzag_enc(v) if signed else v) for v in vals)
    return _ld(no, body)


class _StringTable:
    """Index 0 is reserved empty per spec; strings dedupe to one index."""

    def __init__(self):
        self._idx = {"": 0}
        self.strings = [""]

    def __call__(self, s: str) -> int:
        if s not in self._idx:
            self._idx[s] = len(self.strings)
            self.strings.append(s)
        return self._idx[s]

    def encode(self) -> bytes:
        return _ld(1, b"".join(_ld(1, s.encode("utf-8"))
                               for s in self.strings))


def _write_blob(out, btype: str, payload: bytes, compress: bool) -> None:
    if compress:
        blob = (_field(2, 0, _varint(len(payload)))
                + _ld(3, zlib.compress(payload)))
    else:
        blob = _ld(1, payload)
    header = _ld(1, btype.encode()) + _field(3, 0, _varint(len(blob)))
    out.write(struct.pack(">I", len(header)))
    out.write(header)
    out.write(blob)


def write_osm_pbf(
    path: str,
    node_pos: "dict[int, tuple[float, float]]",
    ways: "list[tuple[int, list[int], dict[str, str]]]",
    relations: "list[tuple[dict[str, str], list[tuple[str, str, int]]]]" = (),
    granularity: int = 100,
    compress: bool = True,
) -> None:
    """Write elements as a spec-conformant .osm.pbf (one PrimitiveBlock).

    Inputs mirror build_network's: node_pos {id: (lon, lat)}, ways
    (id, refs, tags), relations (tags, [(role, member type, ref)...]).
    """
    st = _StringTable()
    group = bytearray()

    ids = sorted(node_pos)
    # Round-to-nearest grid unit (not floor): halves the quantization
    # error and avoids a systematic south-west bias for negative coords.
    lat_raw = [round(node_pos[n][1] * 1e9 / granularity) for n in ids]
    lon_raw = [round(node_pos[n][0] * 1e9 / granularity) for n in ids]
    dense = (_packed(1, ids, signed=True, delta=True)
             + _packed(8, lat_raw, signed=True, delta=True)
             + _packed(9, lon_raw, signed=True, delta=True))
    group += _ld(2, dense)

    for wid, refs, tags in ways:
        body = (_field(1, 0, _varint(wid))
                + _packed(2, [st(k) for k in tags])
                + _packed(3, [st(v) for v in tags.values()])
                + _packed(8, list(refs), signed=True, delta=True))
        group += _ld(3, body)

    for i, (tags, members) in enumerate(relations):
        body = (_field(1, 0, _varint(i + 1))
                + _packed(2, [st(k) for k in tags])
                + _packed(3, [st(v) for v in tags.values()])
                + _packed(8, [st(role) for role, _, _ in members])
                + _packed(9, [m for _, _, m in members],
                          signed=True, delta=True)
                + _packed(10, [_MEMBER_TYPES.index(t)
                               for _, t, _ in members]))
        group += _ld(4, body)

    block = st.encode() + _ld(2, bytes(group))
    if granularity != 100:
        block += _field(17, 0, _varint(granularity))

    header_block = (_ld(4, b"OsmSchema-V0.6") + _ld(4, b"DenseNodes"))
    with open(path, "wb") as f:
        _write_blob(f, "OSMHeader", header_block, compress)
        _write_blob(f, "OSMData", block, compress)
