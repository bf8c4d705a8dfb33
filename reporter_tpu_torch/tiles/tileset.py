"""TileSet — the compiled road graph of one metro, and its device tables.

Counterpart: reporter_tpu/tiles/tileset.py. Every array is flat, fixed
dtype and padded with sentinels (glossary: N nodes, E directed edges,
S line segments, G OSMLR segments, M reach-table width):

  node_xy        f32 [N,2]   node position, tile-local meters
  node_out       i32 [N,D]   outgoing directed-edge ids, -1 padded
  edge_src/dst   i32 [E]     endpoint node ids
  edge_len       f32 [E]     polyline length (m)
  edge_way       i64 [E]     source way id
  edge_speed     f32 [E]     free-flow speed (m/s)
  edge_opp       i32 [E]     opposite directed edge, -1 if one-way
  edge_osmlr     i32 [E]     OSMLR table row, -1 if unassociated
  edge_osmlr_off f32 [E]     meters from OSMLR segment start to edge start
  osmlr_id       i64 [G]     stable OSMLR segment id
  osmlr_len      f32 [G]     full segment length (m)
  seg_a/seg_b    f32 [S,2]   line-segment endpoints (edge shapes decomposed)
  seg_edge       i32 [S]     owning directed edge
  seg_off        f32 [S]     distance along edge at seg_a
  seg_len        f32 [S]     |seg_b - seg_a|
  reach_to       i32 [R,M]   nearby reachable target edges, -1 padded
  reach_dist     f32 [R,M]   network distance row-source → start-of-target (m)
  reach_next     i32 [R,M]   first edge of that path (next-hop, for host walk)
  edge_reach_row i32 [E]     reach row governing transitions out of edge e
  ban_from/ban_to i32 [B]    banned turn pairs (from edge → to edge)

Reach rows are node-keyed: R = N, edge_reach_row[e] == edge_dst[e]. Turn
restrictions add a private ban-aware row per restriction from-edge (R =
N + F) and repoint edge_reach_row there (tiles/reach.py); the device
tables stage all R rows as they are.

The device side stages only what the dense path reads
(``tables_from_numpy``). The JAX package's spatial grid is not kept: the
grid candidate backend is not part of this port. ``save`` / ``load`` use
the JAX package's ``.npz`` layout and schema check, so the two packages
read each other's files: the port writes an empty grid and drops the
grid it reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

ARRAY_FIELDS = (
    "node_xy", "node_out",
    "edge_src", "edge_dst", "edge_len", "edge_way", "edge_speed", "edge_opp",
    "edge_osmlr", "edge_osmlr_off",
    "osmlr_id", "osmlr_len",
    "seg_a", "seg_b", "seg_edge", "seg_off", "seg_len",
    "reach_to", "reach_dist", "reach_next", "edge_reach_row",
    "ban_from", "ban_to",
)


# the JAX package's tile file schema (reach rows ascending by target id)
_SCHEMA = 4


class TileMeta(NamedTuple):
    """Projection metadata: (lon, lat) of the tile-local frame's origin."""

    origin_lonlat: tuple[float, float]


@dataclass
class TileSet:
    name: str
    meta: TileMeta
    node_xy: np.ndarray
    node_out: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_len: np.ndarray
    edge_way: np.ndarray
    edge_speed: np.ndarray
    edge_opp: np.ndarray
    edge_osmlr: np.ndarray
    edge_osmlr_off: np.ndarray
    osmlr_id: np.ndarray
    osmlr_len: np.ndarray
    seg_a: np.ndarray
    seg_b: np.ndarray
    seg_edge: np.ndarray
    seg_off: np.ndarray
    seg_len: np.ndarray
    reach_to: np.ndarray
    reach_dist: np.ndarray
    reach_next: np.ndarray
    edge_reach_row: np.ndarray
    ban_from: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    ban_to: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    stats: dict[str, Any] = field(default_factory=dict)
    _ban_set: "set[tuple[int, int]] | None" = field(
        default=None, init=False, repr=False, compare=False)

    @property
    def ban_set(self) -> "set[tuple[int, int]]":
        """The banned (from_edge, to_edge) pairs as a set (built once)."""
        if self._ban_set is None:
            self._ban_set = {(int(a), int(b))
                             for a, b in zip(self.ban_from, self.ban_to)}
        return self._ban_set

    @property
    def num_edges(self) -> int:
        return int(len(self.edge_len))

    @property
    def num_nodes(self) -> int:
        return int(len(self.node_xy))

    def arrays(self) -> dict[str, np.ndarray]:
        return {f: getattr(self, f) for f in ARRAY_FIELDS}

    # ---- persistence (the JAX package's .npz layout) ----------------------

    def save(self, path: str) -> str:
        """Write the tile as the JAX package's schema-4 ``.npz`` (``.npz``
        appended where missing) → the path written. The grid fields are
        empty: this port builds no spatial grid."""
        import json

        if not path.endswith(".npz"):
            path += ".npz"
        payload = {f: getattr(self, f) for f in ARRAY_FIELDS}
        payload["grid"] = np.full((0, 1), -1, np.int32)
        # TileMeta of the JAX package: grid origin, cell size, grid dims,
        # origin (lon, lat), index radius
        meta = [[0.0, 0.0], 0.0, [0, 0], list(self.meta.origin_lonlat), 0.0]
        payload["_meta"] = np.frombuffer(
            json.dumps({"name": self.name, "meta": meta,
                        "stats": self.stats, "schema": _SCHEMA}).encode(),
            dtype=np.uint8)
        np.savez_compressed(path, **payload)
        return path

    @classmethod
    def load(cls, path: str) -> "TileSet":
        """Read a schema-4 ``.npz`` written by either package (``python -m
        reporter_tpu.tiles build``, or ``save``), turn-restricted or not.
        Another schema raises ValueError, as in the JAX package."""
        import json

        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as z:
            raw = json.loads(bytes(z["_meta"]).decode())
            if raw.get("schema", 1) != _SCHEMA:
                raise ValueError(
                    f"{path}: tileset schema {raw.get('schema', 1)} predates "
                    "the id-sorted reach rows (binary-searched by the "
                    "native walker); recompile the network")
            if len(raw["meta"]) != 5:
                raise ValueError(
                    f"{path}: tileset metadata has {len(raw['meta'])} "
                    "fields, expected 5; recompile the network")
            arrays = {f: z[f] for f in ARRAY_FIELDS}
        out = cls.from_arrays(raw["name"], tuple(raw["meta"][3]), arrays)
        out.stats = raw.get("stats", {})
        return out

    @classmethod
    def from_arrays(cls, name: str, origin_lonlat: "tuple[float, float]",
                    arrays: "dict[str, np.ndarray]") -> "TileSet":
        """A TileSet over arrays compiled elsewhere (for example by the JAX
        package's compiler): the named fields are taken as they are, other
        keys are ignored; a tile without ``ban_from`` / ``ban_to`` has no
        banned turns."""
        return cls(name=name, meta=TileMeta(tuple(origin_lonlat)),
                   **{k: np.asarray(v) for k, v in arrays.items()
                      if k in ARRAY_FIELDS})


def tables_from_numpy(arrays: "dict[str, np.ndarray]",
                      device: "str | torch.device") -> "dict[str, torch.Tensor]":
    """The device tables of the dense path, as torch tensors on ``device``.

    ``arrays`` holds a tile's numpy arrays by their TileSet names (this
    port's ``TileSet.arrays()``, or the same fields of a reporter_tpu
    TileSet). The segment pack is built here with this port's
    build_seg_pack, with the port's seg_sweep and seg_coarse tables beside
    the JAX package's four; every array keeps its dtype and bytes (the
    pack's edge row stays the int32 bit pattern inside an f32 row). A
    restricted tile's R = N + F reach rows are staged as they are."""
    from reporter_tpu_torch.ops.dense_candidates import build_seg_pack

    sp = build_seg_pack(arrays["seg_a"], arrays["seg_b"], arrays["seg_edge"],
                        arrays["seg_off"], arrays["seg_len"])
    host = {
        "edge_len": arrays["edge_len"],
        "reach_row": arrays["edge_reach_row"],
        "reach_to": arrays["reach_to"],
        "reach_dist": arrays["reach_dist"],
        "seg_pack": sp.pack,
        "seg_bbox": sp.bbox,
        "seg_sub": sp.sub,
        "seg_feat": sp.feat,
        "seg_sweep": sp.sweep,
        "seg_coarse": sp.coarse,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}
