"""Tile compiler: RoadNetwork → TileSet, for the dense candidate layout.

Counterpart: reporter_tpu/tiles/compiler.py. One offline pass: a mode's
subgraph (``mode=``), directed edges and their polylines, OSMLR chaining
(on the full network for a mode compile, so a road's segment id is the
same in every mode), decomposition into line segments, turn restrictions
lowered to banned edge pairs, the spatial grid of the grid candidate
backend (its capacity doubled while a cell overflows), and the reach
tables: node rows from the C++ builder (tiles/native.py) unless
``CompilerParams(use_native=False)`` picks the Python one, then, on a
restricted tile, the ban-affected node rows and the private from-edge
rows in edge space (tiles/reach.py). The grid's cells are filled by the
C++ builder under the same switch. Every array the port builds equals
the JAX package's compile bit for bit.
"""

from __future__ import annotations

import time

import numpy as np

from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.netgen.network import ACCESS_AUTO, RoadNetwork
from reporter_tpu_torch.tiles.reach import (build_reach_tables,
                                            build_reach_tables_restricted)
from reporter_tpu_torch.tiles.tileset import TileMeta, TileSet


def _build_edges(net: RoadNetwork, node_xy: np.ndarray, origin: np.ndarray):
    """Directed edges + per-edge polylines from ways."""
    src: list[int] = []
    dst: list[int] = []
    way: list[int] = []
    speed: list[float] = []
    shapes: list[np.ndarray] = []          # per-edge [k>=2, 2] xy polyline
    fwd_of_leg: dict[tuple[int, int], int] = {}   # (way_idx, leg) → fwd edge id
    rev_of_leg: dict[tuple[int, int], int] = {}

    for wi, w in enumerate(net.ways):
        for leg in range(len(w.nodes) - 1):
            a, b = w.nodes[leg], w.nodes[leg + 1]
            mid_ll = w.geometry.get(leg)
            if mid_ll is not None and len(mid_ll):
                mid = lonlat_to_xy(mid_ll, origin)
                poly = np.vstack([node_xy[a][None], mid, node_xy[b][None]])
            else:
                poly = np.vstack([node_xy[a][None], node_xy[b][None]])
            fwd_of_leg[(wi, leg)] = len(src)
            src.append(a); dst.append(b); way.append(w.way_id); speed.append(w.speed_mps)
            shapes.append(poly.astype(np.float32))
            if not w.oneway:
                rev_of_leg[(wi, leg)] = len(src)
                src.append(b); dst.append(a); way.append(w.way_id); speed.append(w.speed_mps)
                shapes.append(poly[::-1].astype(np.float32))

    E = len(src)
    edge_opp = np.full(E, -1, dtype=np.int32)
    for key, f in fwd_of_leg.items():
        r = rev_of_leg.get(key)
        if r is not None:
            edge_opp[f] = r
            edge_opp[r] = f
    return (
        np.asarray(src, np.int32), np.asarray(dst, np.int32),
        np.asarray(way, np.int64), np.asarray(speed, np.float32),
        shapes, edge_opp, fwd_of_leg, rev_of_leg,
    )


def _chain_osmlr(net: RoadNetwork, edge_len: np.ndarray,
                 edge_src: np.ndarray, edge_dst: np.ndarray,
                 edge_opp: np.ndarray, fwd_of_leg, rev_of_leg,
                 max_len: float):
    """Directional OSMLR chaining with cross-way continuation.

      1. within a way, consecutive legs always chain;
      2. across a way boundary, the chain continues iff the joint node has
         geometric degree 2 (the road merely changes way id there);
      3. chains split greedily into chunks of ≤ ``max_len`` meters.

    Stable ids pack (first edge's way_id << 20) | (direction << 19) | chunk,
    where ``chunk`` counts chunks per (way_id, direction) in first-edge
    order. Every directed edge belongs to exactly one chain; pure cycles
    start at their lowest edge id.
    """
    E = len(edge_len)
    edge_osmlr = np.full(E, -1, dtype=np.int32)
    edge_osmlr_off = np.zeros(E, dtype=np.float32)
    osmlr_ids: list[int] = []
    osmlr_lens: list[float] = []

    # edge → (way index, leg, direction); direction 1 = against the way
    edge_leg: dict[int, tuple[int, int, int]] = {}
    for (wi, leg), e in fwd_of_leg.items():
        edge_leg[e] = (wi, leg, 0)
    for (wi, leg), e in rev_of_leg.items():
        edge_leg[e] = (wi, leg, 1)

    # geometric node degree = number of incident undirected legs
    node_deg = np.zeros(net.num_nodes, dtype=np.int32)
    for (wi, leg), e in fwd_of_leg.items():
        node_deg[edge_src[e]] += 1
        node_deg[edge_dst[e]] += 1

    out_edges: dict[int, list[int]] = {}
    for e in range(E):
        out_edges.setdefault(int(edge_src[e]), []).append(e)

    def succ(e: int) -> int | None:
        wi, leg, d = edge_leg[e]
        nxt = (fwd_of_leg.get((wi, leg + 1)) if d == 0
               else rev_of_leg.get((wi, leg - 1)))
        if nxt is not None:
            return nxt                      # rule 1: same way continues
        u = int(edge_dst[e])
        if node_deg[u] != 2:
            return None                     # junction: chain ends
        cands = [x for x in out_edges.get(u, ())
                 if x != e and x != int(edge_opp[e])]
        return cands[0] if len(cands) == 1 else None

    preds = set()
    for e in range(E):
        s = succ(e)
        if s is not None:
            preds.add(s)

    def walk(start: int, visited: np.ndarray) -> list[int]:
        chain = []
        e = start
        while e is not None and not visited[e]:
            visited[e] = True
            chain.append(e)
            e = succ(e)
        return chain

    visited = np.zeros(E, dtype=bool)
    chains: list[list[int]] = []
    for e in range(E):                      # chain heads first…
        if e not in preds and not visited[e]:
            chains.append(walk(e, visited))
    for e in range(E):                      # …then pure cycles
        if not visited[e]:
            chains.append(walk(e, visited))

    chunk_counter: dict[tuple[int, int], int] = {}
    for chain in chains:                    # chains are in first-edge order
        wi, _, d = edge_leg[chain[0]]
        base = (net.ways[wi].way_id, d)
        cur: list[int] = []
        cur_len = 0.0

        def flush() -> None:
            nonlocal cur, cur_len
            if not cur:
                return
            chunk = chunk_counter.get(base, 0)
            chunk_counter[base] = chunk + 1
            row = len(osmlr_ids)
            osmlr_ids.append((base[0] << 20) | (base[1] << 19) | chunk)
            off = 0.0
            for e in cur:
                edge_osmlr[e] = row
                edge_osmlr_off[e] = off
                off += float(edge_len[e])
            osmlr_lens.append(off)
            cur = []
            cur_len = 0.0

        for e in chain:
            if cur and cur_len + float(edge_len[e]) > max_len:
                flush()
            cur.append(e)
            cur_len += float(edge_len[e])
        flush()

    return (edge_osmlr, edge_osmlr_off,
            np.asarray(osmlr_ids, np.int64), np.asarray(osmlr_lens, np.float32))


def _full_graph_osmlr(full_net: RoadNetwork, sub_net: RoadNetwork,
                      sub_E: int, sub_fwd, sub_rev, max_len: float):
    """The OSMLR association of the full (all-mode) network, mapped onto a
    mode subgraph's edges by (way_id, leg, direction): a road's segment
    id is the same whichever mode names it. A subgraph edge the full
    network lacks (a pedestrian walking a one-way street backwards) stays
    unassociated (-1)."""
    # keyed by content, not identity: callers mutate a network in place
    # between compiles, and an identity key would serve a stale association
    fp = (max_len, full_net.fingerprint())
    cached = getattr(full_net, "_osmlr_assoc", None)
    if cached is not None and cached[0] == fp:
        f_osmlr, f_off, ids, lens, by_key = cached[1]
    else:
        origin = full_net.origin()
        node_xy = lonlat_to_xy(full_net.node_lonlat,
                               origin).astype(np.float32)
        (fsrc, fdst, _fway, _fspeed, fshapes, fopp,
         f_fwd, f_rev) = _build_edges(full_net, node_xy, origin)
        # polyline lengths directly: only this column of the segment
        # decomposition is needed
        f_edge_len = np.asarray(
            [float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())
             for p in fshapes], np.float32)
        f_osmlr, f_off, ids, lens = _chain_osmlr(
            full_net, f_edge_len, fsrc, fdst, fopp, f_fwd, f_rev, max_len)
        by_key = {}
        for (wi, leg), e in f_fwd.items():
            by_key[(full_net.ways[wi].way_id, leg, 0)] = e
        for (wi, leg), e in f_rev.items():
            by_key[(full_net.ways[wi].way_id, leg, 1)] = e
        full_net._osmlr_assoc = (fp, (f_osmlr, f_off, ids, lens, by_key))

    edge_osmlr = np.full(sub_E, -1, dtype=np.int32)
    edge_osmlr_off = np.zeros(sub_E, dtype=np.float32)
    for legs, d in ((sub_fwd, 0), (sub_rev, 1)):
        for (wi, leg), e in legs.items():
            fe = by_key.get((sub_net.ways[wi].way_id, leg, d))
            if fe is not None:
                edge_osmlr[e] = f_osmlr[fe]
                edge_osmlr_off[e] = f_off[fe]
    return edge_osmlr, edge_osmlr_off, ids, lens


def _decompose_segments(shapes: list[np.ndarray]):
    """Edge polylines → flat line-segment arrays."""
    seg_a, seg_b, seg_edge, seg_off = [], [], [], []
    edge_len = np.zeros(len(shapes), dtype=np.float32)
    for e, poly in enumerate(shapes):
        off = 0.0
        for i in range(len(poly) - 1):
            a, b = poly[i], poly[i + 1]
            L = float(np.linalg.norm(b - a))
            if L <= 1e-6:
                continue
            seg_a.append(a); seg_b.append(b); seg_edge.append(e); seg_off.append(off)
            off += L
        edge_len[e] = off
    seg_a = np.asarray(seg_a, np.float32).reshape(-1, 2)
    seg_b = np.asarray(seg_b, np.float32).reshape(-1, 2)
    seg_len = np.linalg.norm(seg_b - seg_a, axis=1).astype(np.float32)
    return (seg_a, seg_b, np.asarray(seg_edge, np.int32),
            np.asarray(seg_off, np.float32), seg_len, edge_len)


def _build_grid(seg_a: np.ndarray, seg_b: np.ndarray, cell_size: float,
                capacity: int, index_radius: float, use_native: bool = False):
    """Padded uniform grid over line segments, dilated by ``index_radius``:
    a segment is registered in every cell within ``index_radius`` of its
    bbox, so a point reads its own cell's row alone and still sees every
    segment within a search radius up to ``index_radius``. → (grid i32
    [gw*gh, capacity] -1 padded, (gw, gh), origin f64 [2], registrations
    dropped by full cells). Cells are filled in segment order, so a row
    lists its segments (and edges) ascending. ``use_native`` fills them
    with the C++ builder (tiles/native.py), byte for byte this loop."""
    smin = np.minimum(seg_a, seg_b) - index_radius
    smax = np.maximum(seg_a, seg_b) + index_radius
    lo = smin.min(axis=0) - 1.0
    hi = smax.max(axis=0) + 1.0
    gw = max(1, int(np.ceil((hi[0] - lo[0]) / cell_size)))
    gh = max(1, int(np.ceil((hi[1] - lo[1]) / cell_size)))
    if use_native:
        from reporter_tpu_torch.tiles.native import build_grid_native

        grid, overflow = build_grid_native(smin, smax, lo, cell_size, gw, gh,
                                           capacity)
        return grid, (gw, gh), lo.astype(np.float64), overflow
    grid = np.full((gw * gh, capacity), -1, dtype=np.int32)
    counts = np.zeros(gw * gh, dtype=np.int32)
    overflow = 0
    c0 = np.floor((smin - lo) / cell_size).astype(np.int64)
    c1 = np.floor((smax - lo) / cell_size).astype(np.int64)
    c0 = np.clip(c0, 0, [gw - 1, gh - 1])
    c1 = np.clip(c1, 0, [gw - 1, gh - 1])
    for s in range(len(seg_a)):
        for cx in range(c0[s, 0], c1[s, 0] + 1):
            for cy in range(c0[s, 1], c1[s, 1] + 1):
                cell = cx * gh + cy
                if counts[cell] < capacity:
                    grid[cell, counts[cell]] = s
                    counts[cell] += 1
                else:
                    overflow += 1
    return grid, (gw, gh), lo.astype(np.float64), overflow


def _build_sized_grid(seg_a: np.ndarray, seg_b: np.ndarray,
                      params: CompilerParams, use_native: bool):
    """``_build_grid`` at the compiler's capacity: it starts at
    ``params.cell_capacity`` and doubles while a cell overflows (an
    overflowed cell hides candidates from the grid backend), up to 1024;
    it costs offline time and a table only a grid matcher stages. →
    (grid, (gw, gh), origin, registrations dropped, capacity)."""
    capacity = params.cell_capacity
    while True:
        grid, dims, origin, overflow = _build_grid(
            seg_a, seg_b, params.cell_size, capacity, params.index_radius,
            use_native=use_native)
        if not overflow or capacity >= 1024:
            return grid, dims, origin, overflow, capacity
        capacity *= 2


def _build_node_out(num_nodes: int, edge_src: np.ndarray):
    order = np.argsort(edge_src, kind="stable")
    degree = np.bincount(edge_src, minlength=num_nodes)
    dmax = max(1, int(degree.max()) if len(degree) else 1)
    node_out = np.full((num_nodes, dmax), -1, dtype=np.int32)
    fill = np.zeros(num_nodes, dtype=np.int32)
    for e in order:
        u = edge_src[e]
        node_out[u, fill[u]] = e
        fill[u] += 1
    return node_out


def compile_network(net: RoadNetwork, params: "CompilerParams | None" = None,
                    mode: "str | None" = None) -> TileSet:
    """Compile a RoadNetwork into a TileSet.

    ``mode`` ("auto" / "bicycle" / "foot") compiles the mode's legal
    subgraph (RoadNetwork.for_mode), with the full network's OSMLR
    association and origin, so every mode's tile names a road by the same
    segment id. None compiles the network as it is, except a mixed
    network (drivable and non-drivable ways), which compiles its auto
    subgraph with a warning: an unqualified compile means the drivable
    graph. A network already filtered by for_mode, or with no drivable
    way at all, compiles as it is; its OSMLR chains are then the
    subgraph's own."""
    params = params or CompilerParams()
    full_net = net
    if (mode is None and net.mode is None
            and any(not (w.access_mask & ACCESS_AUTO) for w in net.ways)
            and any(w.access_mask & ACCESS_AUTO for w in net.ways)):
        import warnings

        warnings.warn(
            f"network {net.name!r} contains non-drivable ways; "
            "compiling the auto subgraph (pass mode=... to silence)",
            stacklevel=2)
        mode = "auto"
    if mode is not None:
        net = net.for_mode(mode)
    if net.num_nodes == 0 or not net.ways:
        raise ValueError(
            f"RoadNetwork {net.name!r} has no drivable ways/nodes; nothing to compile")
    t0 = time.time()
    # a mode compile projects in the full network's frame: the mapped
    # OSMLR offsets and lengths were measured there
    origin = (full_net if mode is not None else net).origin()
    node_xy = lonlat_to_xy(net.node_lonlat, origin).astype(np.float32)

    (edge_src, edge_dst, edge_way, edge_speed,
     shapes, edge_opp, fwd_of_leg, rev_of_leg) = _build_edges(net, node_xy, origin)

    seg_a, seg_b, seg_edge, seg_off, seg_len, edge_len = _decompose_segments(shapes)

    if mode is not None:
        edge_osmlr, edge_osmlr_off, osmlr_id, osmlr_len = _full_graph_osmlr(
            full_net, net, len(edge_len), fwd_of_leg, rev_of_leg,
            params.osmlr_max_length)
    else:
        edge_osmlr, edge_osmlr_off, osmlr_id, osmlr_len = _chain_osmlr(
            net, edge_len, edge_src, edge_dst, edge_opp, fwd_of_leg,
            rev_of_leg, params.osmlr_max_length)

    grid, grid_dims, grid_origin, overflow, capacity = _build_sized_grid(
        seg_a, seg_b, params, params.use_native)

    node_out = _build_node_out(net.num_nodes, edge_src)
    banned_pairs = _resolve_restrictions(net, edge_src, edge_dst, edge_way,
                                         node_out)
    (reach_to, reach_dist, reach_next, truncated,
     edge_reach_row) = _build_reach(
        node_out, edge_src, edge_dst, edge_len, node_xy, banned_pairs, params)

    if overflow:
        import warnings

        warnings.warn(
            f"{net.name}: spatial grid dropped {overflow} segment "
            f"registrations even at the auto-sizing ceiling "
            f"(cell_capacity={capacity}, started at {params.cell_capacity});"
            " candidate search may miss roads in dense cells — shrink "
            "cell_size or thin the network", stacklevel=2)

    return TileSet(
        name=net.name,
        meta=TileMeta(
            grid_origin=(float(grid_origin[0]), float(grid_origin[1])),
            cell_size=float(params.cell_size), grid_dims=grid_dims,
            origin_lonlat=(float(origin[0]), float(origin[1])),
            index_radius=float(params.index_radius)),
        node_xy=node_xy, node_out=node_out,
        edge_src=edge_src, edge_dst=edge_dst, edge_len=edge_len,
        edge_way=edge_way, edge_speed=edge_speed, edge_opp=edge_opp,
        edge_osmlr=edge_osmlr, edge_osmlr_off=edge_osmlr_off,
        osmlr_id=osmlr_id, osmlr_len=osmlr_len,
        seg_a=seg_a, seg_b=seg_b, seg_edge=seg_edge, seg_off=seg_off,
        seg_len=seg_len, grid=grid,
        reach_to=reach_to, reach_dist=reach_dist, reach_next=reach_next,
        edge_reach_row=edge_reach_row,
        ban_from=banned_pairs[:, 0].copy(),
        ban_to=banned_pairs[:, 1].copy(),
        stats={
            "nodes": int(net.num_nodes), "edges": int(len(edge_len)),
            "line_segments": int(len(seg_a)),
            "osmlr_segments": int(len(osmlr_id)),
            "grid_cells": int(grid_dims[0] * grid_dims[1]),
            "grid_overflow": int(overflow),
            "reach_truncated_nodes": int(truncated),
            "restrictions": len(net.restrictions),
            "banned_turn_pairs": int(len(banned_pairs)),
            **({"mode": mode} if mode is not None else {}),
            "compile_seconds": round(time.time() - t0, 3),
        },
    )


def _resolve_restrictions(net: RoadNetwork, edge_src, edge_dst, edge_way,
                          node_out) -> np.ndarray:
    """TurnRestrictions (way ids and a via node) → banned directed-edge
    pairs [B, 2], ascending. ``no_*`` bans the named (from, to) pairs;
    ``only_*`` bans every other exit of the from-edge at the via node. A
    relation whose ways do not meet the via node in the needed direction
    is dropped with a warning."""
    banned: set[tuple[int, int]] = set()
    dropped = 0
    if not net.restrictions:
        return np.zeros((0, 2), np.int32)
    by_way: dict[int, list[int]] = {}
    for e, w in enumerate(edge_way):
        by_way.setdefault(int(w), []).append(e)
    for r in net.restrictions:
        u = int(r.via_node)
        from_edges = [e for e in by_way.get(r.from_way, ())
                      if int(edge_dst[e]) == u]
        to_edges = {e for e in by_way.get(r.to_way, ())
                    if int(edge_src[e]) == u}
        if not from_edges or not to_edges:
            dropped += 1
            continue
        outs = [int(e) for e in node_out[u] if e >= 0]
        for ef in from_edges:
            if r.mandatory:
                banned.update((ef, x) for x in outs if x not in to_edges)
            else:
                banned.update((ef, int(t)) for t in to_edges)
    if dropped:
        import warnings

        warnings.warn(f"{net.name}: dropped {dropped} unresolvable turn "
                      "restrictions", stacklevel=2)
    if not banned:
        return np.zeros((0, 2), np.int32)
    return np.asarray(sorted(banned), np.int32)


def _node_space_reach(node_out, edge_src, edge_dst, edge_len,
                      params: CompilerParams):
    """The unrestricted node rows: the C++ builder, or the Python one
    under ``use_native=False`` (bit-equal). → (to, dist, next,
    truncated)."""
    if params.use_native:
        from reporter_tpu_torch.tiles.native import build_reach_native

        return build_reach_native(node_out, edge_src, edge_dst, edge_len,
                                  params.reach_radius, params.reach_max)
    return build_reach_tables(node_out, edge_src, edge_dst, edge_len,
                              params.reach_radius, params.reach_max)


def _build_reach(node_out, edge_src, edge_dst, edge_len, node_xy,
                 banned_pairs, params: CompilerParams):
    """The reach tables and the edge → row map: the node-space build, then
    on a restricted tile the ban-affected ball of node rows and the
    private from-edge rows in edge space (bans are sparse, so the
    node-space builder keeps most of the work)."""
    base = _node_space_reach(node_out, edge_src, edge_dst, edge_len, params)
    if not len(banned_pairs):
        return (*base, edge_dst.astype(np.int32).copy())
    return build_reach_tables_restricted(
        node_out, edge_src, edge_dst, edge_len,
        params.reach_radius, params.reach_max, banned_pairs,
        base=base[:3], node_xy=node_xy)
