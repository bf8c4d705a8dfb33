"""TileSet — the compiled road graph of one metro, and its device tables.

Counterpart: reporter_tpu/tiles/tileset.py. Every array is flat, fixed
dtype and padded with sentinels (glossary: N nodes, E directed edges,
S line segments, G OSMLR segments, C grid cell capacity, M reach-table
width):

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
  grid           i32 [ncells,C]  line-segment ids per spatial cell, -1 padded
  reach_to       i32 [R,M]   nearby reachable target edges, -1 padded
  reach_dist     f32 [R,M]   network distance row-source → start-of-target (m)
  reach_next     i32 [R,M]   first edge of that path (next-hop, for host walk)
  edge_reach_row i32 [E]     reach row governing transitions out of edge e
  ban_from/ban_to i32 [B]    banned turn pairs (from edge → to edge)

Reach rows are node-keyed: R = N, edge_reach_row[e] == edge_dst[e]. Turn
restrictions add a private ban-aware row per restriction from-edge (R =
N + F) and repoint edge_reach_row there (tiles/reach.py); the device
tables stage all R rows as they are.

The grid registers every line segment in each cell within
``index_radius`` of its bbox (tiles/compiler.py), so one cell row holds
every segment a point of that cell can have within that radius.

``host_tables`` builds what the matcher's candidate backend reads, as
host numpy arrays: the dense sweep's segment pack, or the grid backend's
``cell_pack`` (``build_cell_pack``: one f32 [8*C] row per cell with every
registered segment's geometry inline, so a point's candidates are one
contiguous row gather), beside a ``staged_layout`` version tag and, on
the dense layout, the ``tuned_plan`` vector. ``place_tables`` puts the
arrays on a device; the tag and the plan stay host values (the port's
wire entries do not take them). ``tables_from_numpy`` is the two in a
row, the tensors alone: the matcher and the fleet's cold tier
(fleet/residency.py) share this one staging path. ``check_staged_layout``
guards every seam that takes a dict built elsewhere. ``save`` / ``load``
use the JAX package's ``.npz`` layout and schema check, grid and grid
metadata included, so the two packages read each other's files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

# cell_pack component slots (axis 1 of its [ncells, PACK_NCOMP, C] view)
PACK_AX, PACK_AY, PACK_BX, PACK_BY = 0, 1, 2, 3
PACK_OFF, PACK_LEN, PACK_EDGE, PACK_SPARE = 4, 5, 6, 7
PACK_NCOMP = 8

ARRAY_FIELDS = (
    "node_xy", "node_out",
    "edge_src", "edge_dst", "edge_len", "edge_way", "edge_speed", "edge_opp",
    "edge_osmlr", "edge_osmlr_off",
    "osmlr_id", "osmlr_len",
    "seg_a", "seg_b", "seg_edge", "seg_off", "seg_len",
    "grid",
    "reach_to", "reach_dist", "reach_next", "edge_reach_row",
    "ban_from", "ban_to",
)


# the JAX package's tile file schema (reach rows ascending by target id)
_SCHEMA = 4

# Version of the staged table layout (the member set host_tables builds),
# the port's own: bumped whenever a staged table is added or changed, so
# a dict built before the change (the fleet keeps its cold tier for the
# process's life) fails at the staging seam instead of in a kernel. The
# number follows the JAX package's layout v3 (the plan vector rides the
# dense layout); the port's dense member set differs from the JAX one
# (seg_sweep and seg_coarse, no edge_osmlr), so a JAX-built dict fails
# the member check.
STAGED_LAYOUT_VERSION = 3

# every member the dense layout must stage: check_staged_layout checks
# the set as well as the tag, so a hand-built dict with a current tag
# and a stale member set fails too
_DENSE_LAYOUT_KEYS = ("seg_pack", "seg_bbox", "seg_sub", "seg_feat",
                      "seg_sweep", "seg_coarse")

# members that stay host values: place_tables passes them through as
# they are, and the matcher's device tables do not hold them
HOST_KEYS = ("staged_layout", "tuned_plan")


class TileMeta(NamedTuple):
    """Grid and projection metadata, the JAX package's fields in its order.
    A tile without a grid keeps the zero defaults (index radius 0: the
    grid backend refuses any search radius on it)."""

    grid_origin: "tuple[float, float]" = (0.0, 0.0)   # xy of cell (0, 0)'s
    #                                                   lower-left corner
    cell_size: float = 0.0
    grid_dims: "tuple[int, int]" = (0, 0)   # (gw, gh); grid is [gw*gh, C]
    origin_lonlat: "tuple[float, float]" = (0.0, 0.0)
    index_radius: float = 0.0          # registration dilation (m): the one
    #                                    cell row covers any search radius
    #                                    up to this


def build_cell_pack(grid: np.ndarray, seg_a: np.ndarray, seg_b: np.ndarray,
                    seg_edge: np.ndarray, seg_off: np.ndarray,
                    seg_len: np.ndarray) -> np.ndarray:
    """The grid and the segment arrays fused into one f32 row per cell,
    [ncells, PACK_NCOMP * C], component-major (all C ax values, then all
    C ay values, ...). Edge ids ride bit-cast int32 → float32; empty slots
    carry edge -1 and zero geometry."""
    ncells, cap = grid.shape
    safe = np.maximum(grid, 0)
    empty = grid < 0
    pack = np.zeros((ncells, PACK_NCOMP, cap), np.float32)
    pack[:, PACK_AX] = seg_a[:, 0][safe]
    pack[:, PACK_AY] = seg_a[:, 1][safe]
    pack[:, PACK_BX] = seg_b[:, 0][safe]
    pack[:, PACK_BY] = seg_b[:, 1][safe]
    pack[:, PACK_OFF] = seg_off[safe]
    pack[:, PACK_LEN] = seg_len[safe]
    edge = np.where(empty, np.int32(-1), seg_edge[safe]).astype(np.int32)
    pack[:, PACK_EDGE] = edge.view(np.float32)
    for comp in (PACK_AX, PACK_AY, PACK_BX, PACK_BY, PACK_OFF, PACK_LEN):
        pack[:, comp][empty] = 0.0
    return pack.reshape(ncells, PACK_NCOMP * cap)


def _no_grid() -> np.ndarray:
    return np.full((0, 1), -1, np.int32)


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
    grid: np.ndarray = field(default_factory=_no_grid)
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

    def host_tables(self, candidate_backend: str = "dense",
                    ) -> "dict[str, np.ndarray]":
        """The staged layout of ``candidate_backend`` as host numpy
        arrays (module ``host_tables``)."""
        return host_tables(self.arrays(), candidate_backend)

    # ---- persistence (the JAX package's .npz layout) ----------------------

    def save(self, path: str) -> str:
        """Write the tile as the JAX package's schema-4 ``.npz`` (``.npz``
        appended where missing) → the path written."""
        import json

        if not path.endswith(".npz"):
            path += ".npz"
        payload = {f: getattr(self, f) for f in ARRAY_FIELDS}
        payload["_meta"] = np.frombuffer(
            json.dumps({"name": self.name, "meta": list(self.meta),
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
        out = cls.from_arrays(raw["name"], raw["meta"], arrays)
        out.stats = raw.get("stats", {})
        return out

    @classmethod
    def from_arrays(cls, name: str, meta, arrays: "dict[str, np.ndarray]",
                    ) -> "TileSet":
        """A TileSet over arrays compiled elsewhere (for example by the JAX
        package's compiler): the named fields are taken as they are, other
        keys are ignored; a tile without ``ban_from`` / ``ban_to`` has no
        banned turns. ``meta`` is a TileMeta, or the JAX package's field
        for field, or the (lon, lat) origin alone for a tile staged
        without its grid metadata."""
        if len(meta) == 2:
            meta = TileMeta(origin_lonlat=tuple(meta))
        else:
            go, cs, gd, ol, ir = meta
            meta = TileMeta(tuple(map(float, go)), float(cs),
                            tuple(map(int, gd)), tuple(map(float, ol)),
                            float(ir))
        return cls(name=name, meta=meta,
                   **{k: np.asarray(v) for k, v in arrays.items()
                      if k in ARRAY_FIELDS})


def check_staged_layout(tables) -> None:
    """Raise ValueError unless ``tables`` is a staged dict of this code's
    layout: a ``staged_layout`` tag (its value checked where it is a host
    number, as host_tables makes it), and on the dense layout every
    member of ``_DENSE_LAYOUT_KEYS`` and ``tuned_plan``. Called at every
    seam that takes a dict built elsewhere: ``SegmentMatcher(...,
    staged_tables=)`` and ``restage_tables`` (the fleet's promotion)."""
    v = tables.get("staged_layout") if hasattr(tables, "get") else None
    if v is None:
        raise ValueError(
            "staged tables carry no staged_layout version tag; rebuild "
            "the dict with TileSet.host_tables()")
    if isinstance(v, (int, np.integer, np.ndarray)) \
            and int(v) != STAGED_LAYOUT_VERSION:
        raise ValueError(
            f"staged tables are layout v{int(v)}, this code stages "
            f"v{STAGED_LAYOUT_VERSION}; rebuild the dict with "
            "TileSet.host_tables()")
    if "seg_pack" in tables:
        missing = [k for k in (*_DENSE_LAYOUT_KEYS, "tuned_plan")
                   if k not in tables]
        if missing:
            raise ValueError(
                f"staged dense layout is missing {missing} despite a "
                "current version tag (a JAX-built dict lacks the port's "
                "seg_sweep and seg_coarse); rebuild with "
                "TileSet.host_tables()")


def host_tables(arrays: "dict[str, np.ndarray]",
                candidate_backend: str = "dense",
                ) -> "dict[str, np.ndarray]":
    """The matcher's staged layout as host numpy arrays.

    ``arrays`` holds a tile's numpy arrays by their TileSet names (this
    port's ``TileSet.arrays()``, or the same fields of a reporter_tpu
    TileSet). ``candidate_backend`` picks the candidate layout, as the
    JAX package's ``host_tables`` does: "dense" (and "auto") the segment
    pack, built here with this port's build_seg_pack, with the port's
    seg_sweep and seg_coarse tables beside the JAX package's four, and
    the static default ``tuned_plan`` vector (the tuner or the plan cache
    overwrites it at staging time); "grid" the ``cell_pack`` of the grid.
    Every array keeps its dtype and bytes (the packs' edge rows stay the
    int32 bit pattern inside f32 rows). A restricted tile's R = N + F
    reach rows are staged as they are. The per-edge and reach members
    and the four shared pack members equal the JAX package's byte for
    byte; ``edge_osmlr``, which the JAX layout stages, is read on the
    host here and is not staged. A ``reach_to`` row whose real target ids
    do not ascend strictly, with the -1 padding at the end, raises
    ValueError: the Viterbi kernel binary-searches the staged rows."""
    from reporter_tpu_torch.ops.dense_candidates import build_seg_pack
    from reporter_tpu_torch.tiles.reach import check_rows_ascending

    if candidate_backend not in ("auto", "dense", "grid"):
        raise ValueError(f"unknown candidate_backend {candidate_backend!r}; "
                         "use 'auto', 'dense' or 'grid'")
    check_rows_ascending(arrays["reach_to"])
    host = {
        "staged_layout": np.int32(STAGED_LAYOUT_VERSION),
        "edge_len": arrays["edge_len"],
        "reach_row": arrays["edge_reach_row"],
        "reach_to": arrays["reach_to"],
        "reach_dist": arrays["reach_dist"],
    }
    if candidate_backend == "grid":
        host["cell_pack"] = build_cell_pack(
            arrays["grid"], arrays["seg_a"], arrays["seg_b"],
            arrays["seg_edge"], arrays["seg_off"], arrays["seg_len"])
    else:
        from reporter_tpu_torch.matcher.autotune import default_plan_array

        sp = build_seg_pack(arrays["seg_a"], arrays["seg_b"],
                            arrays["seg_edge"], arrays["seg_off"],
                            arrays["seg_len"])
        host.update(seg_pack=sp.pack, seg_bbox=sp.bbox, seg_sub=sp.sub,
                    seg_feat=sp.feat, seg_sweep=sp.sweep,
                    seg_coarse=sp.coarse, tuned_plan=default_plan_array())
    return {k: v if k in HOST_KEYS else np.ascontiguousarray(v)
            for k, v in host.items()}


def staged_nbytes(tables: dict) -> int:
    """Bytes of a staged dict's device members (host or placed), the
    host tag and plan excluded: what ``place_tables`` puts on the device
    and ``SegmentMatcher.table_bytes`` counts."""
    return int(sum(v.nbytes for k, v in tables.items()
                   if k not in HOST_KEYS))


def place_tables(host: dict, device: "str | torch.device",
                 ) -> "dict[str, Any]":
    """A staged dict with its device members on ``device``: a numpy
    array through ``torch.from_numpy``, a tensor (a pinned one, in the
    fleet's cold tier) by ``.to(device)``. The members of ``HOST_KEYS``
    pass through as host values."""
    out: "dict[str, Any]" = {}
    for k, v in host.items():
        if k in HOST_KEYS:
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def device_members(tables: dict) -> "dict[str, torch.Tensor]":
    """A placed staged dict's tensors alone (the matcher's tables)."""
    return {k: v for k, v in tables.items() if k not in HOST_KEYS}


def tables_from_numpy(arrays: "dict[str, np.ndarray]",
                      device: "str | torch.device",
                      candidate_backend: str = "dense",
                      ) -> "dict[str, torch.Tensor]":
    """The device tables of the matcher, as torch tensors on ``device``:
    ``host_tables`` then ``place_tables``, the host tag and plan left
    out."""
    return device_members(place_tables(
        host_tables(arrays, candidate_backend), device))
