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
    """Graph-agnostic road network: nodes in lon/lat + ways. Turn
    restrictions are parsed but not compiled by this port (tiles/compiler
    raises)."""

    node_lonlat: np.ndarray              # [N, 2] float64 (lon, lat) degrees
    ways: list[Way]
    name: str = "net"
    restrictions: "list[TurnRestriction]" = field(default_factory=list)

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
