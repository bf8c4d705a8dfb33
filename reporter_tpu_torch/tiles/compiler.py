"""Tile compiler: RoadNetwork → TileSet, for the dense candidate layout.

Counterpart: reporter_tpu/tiles/compiler.py. One offline pass: directed
edges and their polylines, OSMLR chaining, decomposition into line
segments, and the node-space reach tables. The JAX package's spatial grid
(the grid candidate backend), per-mode subgraphs, turn restrictions and
its C++ reach builder are not part of this port; the arrays it does build
equal the JAX package's pure-Python compile bit for bit.
"""

from __future__ import annotations

import time

import numpy as np

from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.geometry import lonlat_to_xy
from reporter_tpu_torch.netgen.network import ACCESS_AUTO, RoadNetwork
from reporter_tpu_torch.tiles.reach import build_reach_tables
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


def compile_network(net: RoadNetwork,
                    params: CompilerParams | None = None) -> TileSet:
    """Compile an all-drivable, unrestricted RoadNetwork into a TileSet.

    Networks with turn restrictions or with non-drivable ways raise
    NotImplementedError: their ban-aware reach rows and per-mode subgraphs
    are not ported yet."""
    params = params or CompilerParams()
    if net.restrictions:
        raise NotImplementedError(
            f"{net.name}: turn restrictions are not ported yet")
    if any(not (w.access_mask & ACCESS_AUTO) for w in net.ways):
        raise NotImplementedError(
            f"{net.name}: per-mode subgraphs (non-drivable ways) are not "
            "ported yet")
    if net.num_nodes == 0 or not net.ways:
        raise ValueError(
            f"RoadNetwork {net.name!r} has no drivable ways/nodes; nothing to compile")
    t0 = time.time()
    origin = net.origin()
    node_xy = lonlat_to_xy(net.node_lonlat, origin).astype(np.float32)

    (edge_src, edge_dst, edge_way, edge_speed,
     shapes, edge_opp, fwd_of_leg, rev_of_leg) = _build_edges(net, node_xy, origin)

    seg_a, seg_b, seg_edge, seg_off, seg_len, edge_len = _decompose_segments(shapes)

    edge_osmlr, edge_osmlr_off, osmlr_id, osmlr_len = _chain_osmlr(
        net, edge_len, edge_src, edge_dst, edge_opp, fwd_of_leg,
        rev_of_leg, params.osmlr_max_length)

    node_out = _build_node_out(net.num_nodes, edge_src)
    reach_to, reach_dist, reach_next, truncated = build_reach_tables(
        node_out, edge_src, edge_dst, edge_len,
        params.reach_radius, params.reach_max)

    return TileSet(
        name=net.name,
        meta=TileMeta(origin_lonlat=(float(origin[0]), float(origin[1]))),
        node_xy=node_xy, node_out=node_out,
        edge_src=edge_src, edge_dst=edge_dst, edge_len=edge_len,
        edge_way=edge_way, edge_speed=edge_speed, edge_opp=edge_opp,
        edge_osmlr=edge_osmlr, edge_osmlr_off=edge_osmlr_off,
        osmlr_id=osmlr_id, osmlr_len=osmlr_len,
        seg_a=seg_a, seg_b=seg_b, seg_edge=seg_edge, seg_off=seg_off,
        seg_len=seg_len,
        reach_to=reach_to, reach_dist=reach_dist, reach_next=reach_next,
        edge_reach_row=edge_dst.astype(np.int32).copy(),
        stats={
            "nodes": int(net.num_nodes), "edges": int(len(edge_len)),
            "line_segments": int(len(seg_a)),
            "osmlr_segments": int(len(osmlr_id)),
            "reach_truncated_nodes": int(truncated),
            "compile_seconds": round(time.time() - t0, 3),
        },
    )
