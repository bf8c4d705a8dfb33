"""Reachability tables: bounded all-pairs-nearby network distances.

Counterpart: reporter_tpu/tiles/reach.py (the node-space build). For every
node ``u`` the nearest ``max_targets`` edges reachable within ``radius``
meters are kept with their network distance and the first edge of the
path, so a Viterbi transition is a table lookup and the host walk
rebuilds paths by next-hop lookups. Turn-restricted tiles need the
edge-space build, which this port does not have (tiles/compiler raises).
"""

from __future__ import annotations

import heapq

import numpy as np


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
