"""OSM XML parser → RoadNetwork.

Counterpart: reporter_tpu/netgen/osm_xml.py (``xml_elements``,
``parse_osm_xml``, ``build_network``, with ``_access_mask`` and
``_speed_mps``). Supports the subset needed to build a drivable graph:
<node> elements and <way> elements tagged ``highway=*`` from a drivable
whitelist, with ``oneway`` and ``maxspeed`` handling, plus
``type=restriction`` relations, which become ``RoadNetwork.restrictions``.
``build_network`` is the format-independent half that netgen/pbf.py
shares. The same document gives the same RoadNetwork as the JAX
package's parser.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.netgen.network import (ACCESS_ALL, ACCESS_AUTO,
                                               ACCESS_BICYCLE, ACCESS_FOOT,
                                               RoadNetwork, TurnRestriction,
                                               Way)

DRIVABLE_HIGHWAY = {
    "motorway", "trunk", "primary", "secondary", "tertiary", "unclassified",
    "residential", "service", "motorway_link", "trunk_link", "primary_link",
    "secondary_link", "tertiary_link", "living_street",
}

# highway classes that only exist for non-auto modes (kept in the
# RoadNetwork with the matching access bits; the auto compile filters
# them out through RoadNetwork.for_mode)
_MODE_ONLY_HIGHWAY = {
    "cycleway": ACCESS_BICYCLE | ACCESS_FOOT,
    "footway": ACCESS_FOOT,
    "pedestrian": ACCESS_FOOT,
    "steps": ACCESS_FOOT,
    "path": ACCESS_FOOT | ACCESS_BICYCLE,
    # track: agricultural lanes — bike/foot by default here (the pre-mode
    # parser never compiled them for autos; motor_vehicle=yes opts in)
    "track": ACCESS_FOOT | ACCESS_BICYCLE,
}

# classes where non-motor modes are off by DEFAULT (tag overrides apply)
_AUTO_ONLY_HIGHWAY = {"motorway", "motorway_link", "trunk", "trunk_link"}

# Access values that exclude a mode, checked most-specific-first per the
# OSM access hierarchy — each mode has its own override chain.
_NO_ACCESS = {"no", "private", "agricultural", "forestry", "delivery",
              "emergency", "military"}

_MODE_TAG_CHAIN = {
    ACCESS_AUTO: ("motor_vehicle", "vehicle", "access"),
    ACCESS_BICYCLE: ("bicycle", "vehicle", "access"),
    ACCESS_FOOT: ("foot", "access"),
}


def _access_mask(tags: "dict[str, str]") -> int:
    """Per-mode access bits for a way, from its highway class default +
    the OSM access-tag hierarchy (most specific key wins per mode)."""
    hw = tags.get("highway", "")
    if hw in _MODE_ONLY_HIGHWAY:
        default = _MODE_ONLY_HIGHWAY[hw]
    elif hw in _AUTO_ONLY_HIGHWAY:
        default = ACCESS_AUTO
    elif hw in DRIVABLE_HIGHWAY:
        default = ACCESS_ALL
    else:
        return 0
    mask = 0
    for bit, chain in _MODE_TAG_CHAIN.items():
        allowed = bool(default & bit)
        for key in chain:
            v = tags.get(key)
            if v is not None:
                allowed = v not in _NO_ACCESS
                break                 # most specific key decides
        if allowed:
            mask |= bit
    return mask

_DEFAULT_SPEED = {  # m/s by highway class
    "motorway": 29.0, "trunk": 24.5, "primary": 17.9, "secondary": 15.6,
    "tertiary": 13.4, "residential": 11.2, "service": 6.7, "living_street": 4.5,
    # non-auto classes: free-flow for their primary mode
    "cycleway": 5.6, "footway": 1.4, "pedestrian": 1.4, "steps": 0.7,
    "path": 2.8, "track": 8.3,
}

# Interior shape runs longer than this split into separate legs/edges:
# keeps edge offsets far inside the u16 wire range (16.4 km) and candidate
# search output well-conditioned on rural roads with distant junctions.
_MAX_LEG_LENGTH = 5000.0  # meters


def _speed_mps(tags: dict[str, str]) -> float:
    ms = tags.get("maxspeed", "")
    try:
        if ms.endswith("mph"):
            return float(ms[:-3].strip()) * 0.44704
        if ms:
            return float(ms) / 3.6
    except ValueError:
        pass
    hw = tags.get("highway", "")
    return _DEFAULT_SPEED.get(hw.removesuffix("_link"), 13.4)


def xml_elements(source: str):
    """Raw OSM elements off an XML document (path or XML string):
    (node_pos {id: (lon, lat)}, ways [(id, refs, tags)...], relations
    [(tags, [(role, member type, ref)...])...]) — build_network's input
    shape."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()

    node_pos: dict[int, tuple[float, float]] = {}
    for nd in root.iter("node"):
        node_pos[int(nd.get("id"))] = (float(nd.get("lon")), float(nd.get("lat")))

    raw_ways = [(int(w.get("id")),
                 [int(nd.get("ref")) for nd in w.findall("nd")],
                 {t.get("k"): t.get("v") for t in w.findall("tag")})
                for w in root.iter("way")]

    raw_relations = []
    for rel in root.iter("relation"):
        tags = {t.get("k"): t.get("v") for t in rel.findall("tag")}
        members = [(m.get("role"), m.get("type"), int(m.get("ref")))
                   for m in rel.findall("member")]
        raw_relations.append((tags, members))
    return node_pos, raw_ways, raw_relations


def parse_osm_xml(source: str, name: str = "osm") -> RoadNetwork:
    """Parse an .osm XML document (path or XML string) into a RoadNetwork."""
    return build_network(*xml_elements(source), name)


def build_network(
    node_pos: "dict[int, tuple[float, float]]",
    raw_ways: "list[tuple[int, list[int], dict[str, str]]]",
    raw_relations: "list[tuple[dict[str, str], list[tuple[str, str, int]]]]",
    name: str = "osm",
) -> RoadNetwork:
    """Raw OSM elements → RoadNetwork.

    node_pos: osm node id → (lon, lat); raw_ways: (way id, node refs,
    tags); raw_relations: (tags, [(role, member type, ref)...]).
    """
    # Corrupt extracts can carry coordinates outside the WGS84 domain;
    # projecting them would silently warp the local metric (cos-lat goes
    # negative past the pole). Treat such nodes as absent — ways route
    # around them exactly like dangling refs — and say so.
    bad = [nid for nid, (lon, lat) in node_pos.items()
           if not (-180.0 <= lon <= 180.0 and -90.0 <= lat <= 90.0)]
    if bad:
        import warnings

        warnings.warn(
            f"extract {name!r}: dropped {len(bad)} node(s) with "
            f"out-of-range coordinates (e.g. id {bad[0]})", stacklevel=3)
        # drop into a local copy — the caller's dict must survive intact
        # (callers reuse parsed elements across build_network calls)
        node_pos = dict(node_pos)
        for nid in bad:
            del node_pos[nid]

    drivable: list[tuple[int, list[int], dict[str, str], int]] = []
    for way_id, refs, tags in raw_ways:
        mask = _access_mask(tags)
        if not mask:
            continue
        refs = [r for r in refs if r in node_pos]
        # Real extracts contain duplicate consecutive refs — and distinct
        # ids digitized at the SAME position; either way the hop would
        # become a zero-length edge, which the compiler forbids
        # (edge_len > 0), so drop the repeated ref.
        refs = [r for i, r in enumerate(refs)
                if i == 0 or (r != refs[i - 1]
                              and node_pos[r] != node_pos[refs[i - 1]])]
        if len(refs) >= 2:
            drivable.append((way_id, refs, tags, mask))
    raw_ways = drivable

    # Graph simplification: only JUNCTION nodes become graph nodes — way endpoints,
    # nodes shared between drivable ways (or revisited within one), and
    # restriction via nodes. Interior degree-2 refs are curve shape, not
    # topology; they collapse into per-leg edge geometry (Way.geometry →
    # the compiler's per-edge polylines), which keeps node/edge counts —
    # and with them reach tables and HMM transition work — proportional
    # to the road TOPOLOGY instead of to how smoothly the mapper drew the
    # curves. Collapsed runs split at _MAX_LEG_LENGTH so edge offsets
    # stay far inside the u16 wire range.
    ref_count: dict[int, int] = {}
    junction: set[int] = set()
    for _, refs, _, _ in raw_ways:
        junction.add(refs[0])
        junction.add(refs[-1])
        for r in refs:
            n = ref_count.get(r, 0) + 1
            ref_count[r] = n
            if n >= 2:
                junction.add(r)
    for tags, members in raw_relations:
        if tags.get("type") == "restriction":
            for role, mtype, ref in members:
                if role == "via" and mtype == "node":
                    junction.add(ref)

    def leg_split(refs: list[int]):
        """Split one way's refs at junctions (and length caps) into legs:
        (junction refs, {leg index: interior lonlat array}). Lengths come
        from geometry.lonlat_to_xy — the same local metric the compiler
        measures edges in."""
        ll = np.asarray([node_pos[r] for r in refs], np.float64)
        step = np.hypot(*np.diff(lonlat_to_xy(ll, ll[0]), axis=0).T)
        nodes = [refs[0]]
        geometry: dict[int, np.ndarray] = {}
        interior: list[tuple[float, float]] = []
        acc = 0.0
        for j, r in enumerate(refs[1:]):
            acc += float(step[j])
            if r in junction or acc >= _MAX_LEG_LENGTH or r == refs[-1]:
                if interior:
                    geometry[len(nodes) - 1] = np.asarray(interior,
                                                          np.float64)
                nodes.append(r)
                interior = []
                acc = 0.0
            else:
                interior.append(node_pos[r])
        return nodes, geometry

    # Keep only junction nodes; remap to dense indices.
    used: dict[int, int] = {}
    split_ways: list[tuple[int, list[int], dict, dict[str, str], int]] = []
    for way_id, refs, tags, mask in raw_ways:
        nodes, geometry = leg_split(refs)
        split_ways.append((way_id, nodes, geometry, tags, mask))
        for r in nodes:
            if r not in used:
                used[r] = len(used)
    lonlat = np.zeros((len(used), 2), dtype=np.float64)
    for osm_id, idx in used.items():
        lonlat[idx] = node_pos[osm_id]

    ways: list[Way] = []
    drivable_way_ids = set()
    for way_id, refs, geometry, tags, mask in split_ways:
        ow = tags.get("oneway", "no") in ("yes", "true", "1")
        nodes = [used[r] for r in refs]
        if tags.get("oneway") == "-1":
            nodes = nodes[::-1]
            ow = True
            # leg i of the reversed way is original leg L-1-i, driven
            # backwards — reverse its interior points too
            L = len(refs) - 1
            geometry = {L - 1 - i: g[::-1] for i, g in geometry.items()}
        ways.append(
            Way(way_id=way_id, nodes=nodes, oneway=ow, geometry=geometry,
                name=tags.get("name", ""), speed_mps=_speed_mps(tags),
                access_mask=mask)
        )
        drivable_way_ids.add(way_id)

    # Turn restrictions: relations tagged type=restriction with way/from,
    # node/via, way/to members (via-WAY relations are rare and dropped).
    restrictions: list[TurnRestriction] = []
    for tags, members in raw_relations:
        if tags.get("type") != "restriction":
            continue
        kind = tags.get("restriction", "")
        if not (kind.startswith("no_") or kind.startswith("only_")):
            continue
        frm = via = to = None
        for role, mtype, ref in members:
            if role == "from" and mtype == "way":
                frm = ref
            elif role == "via" and mtype == "node":
                via = ref
            elif role == "to" and mtype == "way":
                to = ref
        if (frm in drivable_way_ids and to in drivable_way_ids
                and via in used):
            restrictions.append(TurnRestriction(
                from_way=frm, via_node=used[via], to_way=to, kind=kind))

    return RoadNetwork(node_lonlat=lonlat, ways=ways, name=name,
                       restrictions=restrictions)
