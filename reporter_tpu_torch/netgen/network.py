"""RoadNetwork — the representation between a data source and the tile
compiler.

Counterpart: reporter_tpu/netgen/network.py. Sources (here the synthetic
generator) produce a RoadNetwork; tiles.compiler lowers it to flat arrays.
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
class RoadNetwork:
    """Graph-agnostic road network: nodes in lon/lat + ways. Turn
    restrictions are not compiled by this port (tiles/compiler raises)."""

    node_lonlat: np.ndarray              # [N, 2] float64 (lon, lat) degrees
    ways: list[Way]
    name: str = "net"
    restrictions: list = field(default_factory=list)

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
