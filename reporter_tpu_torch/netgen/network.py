"""RoadNetwork — the representation between a data source and the tile
compiler.

Counterpart: reporter_tpu/netgen/network.py. Sources (the synthetic and
organic generators, the OSM XML parser) produce a RoadNetwork;
tiles.compiler lowers it to flat arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Per-mode access bits (a Way carries the set of modes allowed on it)
ACCESS_AUTO = 1
ACCESS_BICYCLE = 2
ACCESS_FOOT = 4
ACCESS_ALL = ACCESS_AUTO | ACCESS_BICYCLE | ACCESS_FOOT
MODE_BITS = {"auto": ACCESS_AUTO, "bicycle": ACCESS_BICYCLE,
             "foot": ACCESS_FOOT}


@dataclass
class Way:
    """A travelable way: an ordered chain of node indices, optionally with
    intermediate shape geometry per leg (lonlat points strictly between the
    leg's endpoint nodes)."""

    way_id: int
    nodes: list[int]                     # indices into RoadNetwork.node_lonlat
    oneway: bool = False
    name: str = ""
    speed_mps: float = 13.4              # free-flow speed, ~30 mph default
    # leg index i (between nodes[i] and nodes[i+1]) → [k, 2] lonlat shape points
    geometry: dict[int, np.ndarray] = field(default_factory=dict)
    access_mask: int = ACCESS_ALL        # OR of ACCESS_* bits


@dataclass
class TurnRestriction:
    """An OSM turn restriction with a via node (via-way restrictions are
    dropped by the parser). ``kind`` keeps the OSM vocabulary: ``no_*``
    bans that one turn, ``only_*`` bans every other turn from from_way at
    the via node."""

    from_way: int                        # OSM way id the vehicle arrives on
    via_node: int                        # node index into node_lonlat
    to_way: int                          # OSM way id of the (dis)allowed exit
    kind: str = "no_turn"                # "no_*" or "only_*"

    @property
    def mandatory(self) -> bool:
        return self.kind.startswith("only_")


@dataclass
class RoadNetwork:
    """Graph-agnostic road network: nodes in lon/lat + ways."""

    node_lonlat: np.ndarray              # [N, 2] float64 (lon, lat) degrees
    ways: list[Way]
    name: str = "net"
    restrictions: "list[TurnRestriction]" = field(default_factory=list)
    # set by for_mode: marks this network as one mode's subgraph, so
    # compile_network knows an unqualified compile of it is deliberate
    mode: "str | None" = None

    @property
    def num_nodes(self) -> int:
        return int(len(self.node_lonlat))

    def bbox(self) -> tuple[np.ndarray, np.ndarray]:
        lo = self.node_lonlat.min(axis=0)
        hi = self.node_lonlat.max(axis=0)
        return lo, hi

    def origin(self) -> np.ndarray:
        lo, hi = self.bbox()
        return (lo + hi) / 2.0

    def fingerprint(self) -> int:
        """Content crc of the graph (node positions, way topology and
        attributes, per-leg geometry, restrictions): the key of the
        compiler's full-graph OSMLR memo. Anything the compiler reads
        changes it."""
        import zlib

        crc = zlib.crc32(np.ascontiguousarray(self.node_lonlat).tobytes())
        words: list[int] = []
        for w in self.ways:
            words.extend((w.way_id, len(w.nodes), int(w.oneway),
                          w.access_mask, int(w.speed_mps * 100)))
            words.extend(w.nodes)
            for leg in sorted(w.geometry):
                words.append(leg)
                crc = zlib.crc32(np.ascontiguousarray(
                    w.geometry[leg], np.float64).tobytes(), crc)
        for r in self.restrictions:
            words.extend((r.from_way, r.via_node, r.to_way,
                          zlib.crc32(r.kind.encode())))
        return zlib.crc32(np.asarray(words, np.int64).tobytes(), crc)

    def for_mode(self, mode: str) -> "RoadNetwork":
        """The mode's legal subgraph: ways whose access_mask includes
        ``mode``, restrictions filtered to surviving ways, nodes compacted
        to those the kept ways use (in first-use order). Pedestrians
        ignore oneway and turn restrictions: the foot view clears both."""
        import dataclasses

        bit = MODE_BITS.get(mode)
        if bit is None:
            raise ValueError(f"unknown mode {mode!r}; "
                             f"one of {sorted(MODE_BITS)}")
        ways = [w for w in self.ways if w.access_mask & bit]
        if mode == "foot":
            ways = [w if not w.oneway
                    else dataclasses.replace(w, oneway=False) for w in ways]
            restrictions = []
        else:
            keep = {w.way_id for w in ways}
            restrictions = [r for r in self.restrictions
                            if r.from_way in keep and r.to_way in keep]
        # reach tables hold one row per node: orphans of other modes'
        # ways would cost table memory
        used: dict[int, int] = {}
        for w in ways:
            for nd in w.nodes:
                if nd not in used:
                    used[nd] = len(used)
        if len(used) != self.num_nodes:
            node_lonlat = self.node_lonlat[list(used)]
            ways = [dataclasses.replace(
                w, nodes=[used[nd] for nd in w.nodes]) for w in ways]
            restrictions = [dataclasses.replace(r, via_node=used[r.via_node])
                            for r in restrictions if r.via_node in used]
        else:
            node_lonlat = self.node_lonlat
        suffix = "" if mode == "auto" else f"-{mode}"
        return RoadNetwork(node_lonlat=node_lonlat, ways=ways,
                           name=f"{self.name}{suffix}",
                           restrictions=restrictions, mode=mode)
