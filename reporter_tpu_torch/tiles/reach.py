"""Reachability tables: bounded all-pairs-nearby network distances.

Counterpart: reporter_tpu/tiles/reach.py. For every node ``u`` the
nearest ``max_targets`` edges reachable within ``radius`` meters are kept
with their network distance and the first edge of the path, so a Viterbi
transition is a table lookup and the host walk rebuilds paths by
next-hop lookups. Rows are keyed by node: the row of edge ``e`` is
``edge_reach_row[e]``, its destination node.

Turn restrictions (banned from-edge → to-edge pairs) make reachability
depend on the arriving edge. Each restriction from-edge gets a private
row after the N node rows (R = N + F, ``build_reach_tables_restricted``),
and every search on a restricted tile runs in edge space
(``edge_space_targets``, which the CPU oracle shares), so paths through
a restricted node honour its bans too. The C++ builder
(native/reach.cc, tiles/native.py) builds the unrestricted node rows;
this module's ``build_reach_tables`` is its plain version.
"""

from __future__ import annotations

import heapq

import numpy as np


def check_rows_ascending(reach_to: np.ndarray) -> None:
    """The row order the readers of reach rows rely on: the C walker
    (native/walker.cc) and the Viterbi kernel (kernels/viterbi.cu)
    binary-search each row by target edge id, so real ids must ascend
    strictly, with the -1 padding only at the end. Raises ValueError on a
    row that does not."""
    key = np.where(reach_to < 0, np.iinfo(np.int64).max,
                   reach_to.astype(np.int64))
    d = np.diff(key, axis=1)
    real = reach_to[:, 1:] >= 0
    if (d < 0).any() or (real & (d == 0)).any():
        raise ValueError("reach_to rows must ascend by target edge id with "
                         "the -1 padding at the end")


def node_dijkstra(
    u: int,
    node_out: np.ndarray,
    edge_dst: np.ndarray,
    edge_len: np.ndarray,
    radius: float,
) -> dict[int, tuple[float, int]]:
    """Single-source bounded Dijkstra over nodes.

    Returns {node v: (dist(u→v), first_edge_id on a shortest path)}; u itself
    maps to (0.0, -1).
    """
    dist: dict[int, float] = {u: 0.0}
    first: dict[int, int] = {u: -1}
    pq: list[tuple[float, int]] = [(0.0, u)]
    while pq:
        d, v = heapq.heappop(pq)
        if d > dist.get(v, np.inf):
            continue
        for e in node_out[v]:
            if e < 0:
                break
            w = int(edge_dst[e])
            nd = d + float(edge_len[e])
            if nd <= radius and nd < dist.get(w, np.inf):
                dist[w] = nd
                first[w] = int(e) if v == u else first[v]
                heapq.heappush(pq, (nd, w))
    return {v: (dist[v], first[v]) for v in dist}


def build_reach_tables(
    node_out: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_len: np.ndarray,
    radius: float,
    max_targets: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Build (reach_to, reach_dist, reach_next, truncated_nodes); tables are
    each [N, max_targets], keyed by node.

    For node u, targets are out-edges e' of every node v with
    d(u, v) <= radius; reach_dist = d(u, src(e')), reach_next = first edge of
    the u→v path (or e' itself when v == u). The nearest max_targets by
    (dist, id) are kept, then laid out ascending by target id; -1/inf
    padded. The row that governs transitions out of edge e is row
    edge_dst[e].
    """
    num_nodes = len(node_out)
    reach_to = np.full((num_nodes, max_targets), -1, dtype=np.int32)
    reach_dist = np.full((num_nodes, max_targets), np.inf, dtype=np.float32)
    reach_next = np.full((num_nodes, max_targets), -1, dtype=np.int32)

    truncated = 0
    for u in range(num_nodes):
        reached = node_dijkstra(u, node_out, edge_dst, edge_len, radius)
        tos: list[int] = []
        dists: list[float] = []
        nexts: list[int] = []
        for v, (d, fe) in reached.items():
            for e2 in node_out[v]:
                if e2 < 0:
                    break
                tos.append(int(e2))
                dists.append(d)
                nexts.append(int(e2) if v == u else fe)
        if not tos:
            continue
        tos_a = np.asarray(tos)
        order = np.lexsort((tos_a, np.asarray(dists)))
        if len(order) > max_targets:
            truncated += 1
            order = order[:max_targets]
        order = order[np.argsort(tos_a[order], kind="stable")]
        k = len(order)
        reach_to[u, :k] = np.asarray(tos, np.int32)[order]
        reach_dist[u, :k] = np.asarray(dists, np.float32)[order]
        reach_next[u, :k] = np.asarray(nexts, np.int32)[order]

    return reach_to, reach_dist, reach_next, truncated


def edge_space_targets(
    seeds: list[int],
    node_out: np.ndarray,
    edge_dst: np.ndarray,
    edge_len: np.ndarray,
    radius: float,
    banned: "set[tuple[int, int]]",
) -> dict[int, tuple[float, int, int]]:
    """Bounded Dijkstra over edges: {edge e': (distance to the start of
    e', the seed edge beginning the path, the previous edge on the path,
    -1 for a seed)}. Seeds start at distance 0. The expansion e → e2 at
    dst(e) is skipped when (e, e2) is banned. The reach-table builder and
    the CPU oracle both search with it, so they cannot differ on what a
    ban means."""
    dist: dict[int, float] = {}
    first: dict[int, int] = {}
    prev: dict[int, int] = {}
    pq: list[tuple[float, int]] = []
    for e in seeds:
        if 0.0 < dist.get(e, np.inf):
            dist[e] = 0.0
            first[e] = e
            prev[e] = -1
            heapq.heappush(pq, (0.0, e))
    while pq:
        d, e = heapq.heappop(pq)
        if d > dist.get(e, np.inf):
            continue
        nd = d + float(edge_len[e])
        if nd > radius:
            continue
        v = int(edge_dst[e])
        for e2 in node_out[v]:
            if e2 < 0:
                break
            e2 = int(e2)
            if (e, e2) in banned:
                continue
            if nd < dist.get(e2, np.inf):
                dist[e2] = nd
                first[e2] = first[e]
                prev[e2] = e
                heapq.heappush(pq, (nd, e2))
    return {e: (dist[e], first[e], prev[e]) for e in dist}


def _pack_rows(targets: dict[int, tuple[float, int, int]], seeds: set[int],
               max_targets: int,
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """The nearest max_targets by (dist, edge id), laid out ascending by
    target edge id (the walk binary-searches rows). The next hop is the
    target itself for a seed, else the path's first edge. → (to, dist,
    next, whether the row was cut)."""
    tos = np.fromiter(targets.keys(), np.int64, len(targets))
    dists = np.asarray([targets[int(e)][0] for e in tos])
    nexts = np.asarray([int(e) if int(e) in seeds else targets[int(e)][1]
                        for e in tos], np.int32)
    order = np.lexsort((tos, dists))
    cut = len(order) > max_targets
    order = order[:max_targets]
    order = order[np.argsort(tos[order], kind="stable")]
    return (tos[order].astype(np.int32), dists[order].astype(np.float32),
            nexts[order], cut)


def build_reach_tables_restricted(
    node_out: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_len: np.ndarray,
    radius: float,
    max_targets: int,
    banned_pairs: "np.ndarray | list[tuple[int, int]]",
    base: "tuple[np.ndarray, np.ndarray, np.ndarray] | None" = None,
    node_xy: "np.ndarray | None" = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray]:
    """The ban-aware build: (reach_to, reach_dist, reach_next, truncated,
    edge_reach_row). Rows are [N + F, max_targets]: the node rows, then
    one private row per restriction from-edge by ascending edge id;
    edge_reach_row[e] is the row that governs transitions out of e.

    With ``base`` (the unrestricted node rows) and ``node_xy``, only the
    node rows within straight-line ``radius`` of a via node are rebuilt
    in edge space: a network distance is at least the straight one, so
    no other row can reach a ban. ``truncated`` then counts the rows at
    capacity (a superset of the cut rows), else the rows cut."""
    banned = {(int(a), int(b)) for a, b in banned_pairs}
    from_edges = sorted({a for a, _ in banned})
    num_nodes = len(node_out)
    rows = num_nodes + len(from_edges)
    reach_to = np.full((rows, max_targets), -1, dtype=np.int32)
    reach_dist = np.full((rows, max_targets), np.inf, dtype=np.float32)
    reach_next = np.full((rows, max_targets), -1, dtype=np.int32)
    exact_cut = 0

    if base is not None:
        reach_to[:num_nodes] = base[0]
        reach_dist[:num_nodes] = base[1]
        reach_next[:num_nodes] = base[2]

    if base is not None and node_xy is not None:
        via = np.asarray(sorted({int(edge_dst[a]) for a, _ in banned}))
        # a running minimum over the via nodes: O(N) memory, where an
        # [N, V, 2] broadcast would not fit a metro with thousands of bans
        d2_min = np.full(len(node_xy), np.inf)
        for v in via:
            dv = node_xy - node_xy[int(v)]
            np.minimum(d2_min, (dv * dv).sum(-1), out=d2_min)
        affected = np.nonzero(d2_min <= radius * radius)[0]
    else:
        affected = np.arange(num_nodes)

    def fill(row: int, seeds: list[int]) -> None:
        nonlocal exact_cut
        reach_to[row] = -1
        reach_dist[row] = np.inf
        reach_next[row] = -1
        targets = edge_space_targets(seeds, node_out, edge_dst, edge_len,
                                     radius, banned)
        if not targets:
            return
        tos, dists, nexts, cut = _pack_rows(targets, set(seeds), max_targets)
        exact_cut += bool(cut)
        reach_to[row, :len(tos)] = tos
        reach_dist[row, :len(tos)] = dists
        reach_next[row, :len(tos)] = nexts

    for u in affected:
        fill(int(u), [int(e) for e in node_out[u] if e >= 0])
    edge_reach_row = edge_dst.astype(np.int32).copy()
    for i, e_f in enumerate(from_edges):
        u = int(edge_dst[e_f])
        seeds = [int(e) for e in node_out[u]
                 if e >= 0 and (e_f, int(e)) not in banned]
        fill(num_nodes + i, seeds)
        edge_reach_row[e_f] = num_nodes + i
    if base is not None and len(affected) < num_nodes:
        truncated = int((reach_to[:, -1] >= 0).sum())   # rows at capacity
    else:
        truncated = exact_cut
    return reach_to, reach_dist, reach_next, truncated, edge_reach_row


def reach_lookup(reach_to: np.ndarray, reach_dist: np.ndarray,
                 edge_reach_row: np.ndarray, e1: int, e2: int) -> float:
    """Network distance end-of-e1 → start-of-e2, inf outside the table."""
    u = int(edge_reach_row[e1])
    row = reach_to[u]
    hit = np.nonzero(row == e2)[0]
    return float(reach_dist[u, hit[0]]) if len(hit) else float(np.inf)
