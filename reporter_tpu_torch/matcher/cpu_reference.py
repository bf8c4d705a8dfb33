"""Pure-NumPy HMM map matcher: the in-repo Meili stand-in oracle.

Counterpart: reporter_tpu/matcher/cpu_reference.py, operation for
operation in float64. The emission and transition model is the device
path's, but routing between candidates is an exact bounded Dijkstra over
the road graph instead of the precomputed reach tables. Segment-ID
disagreement between this oracle and the device path is the BASELINE
"<5% against Meili" proxy (matcher/fidelity.py). Deliberately simple and
slow; it serves ``matcher_backend="reference_cpu"``, the dispatch
watchdog's fallback and the quality audit, all host work. On a
turn-restricted tile every search runs in edge space through the reach
builder's own ``edge_space_targets``, so the oracle and the tables agree
on what a ban means.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.geometry import point_segment_project
from reporter_tpu_torch.tiles.reach import edge_space_targets
from reporter_tpu_torch.tiles.tileset import TileSet


@dataclass
class _Cand:
    edge: int
    offset: float
    dist: float


def find_candidates_cpu(ts: TileSet, pt: np.ndarray,
                        params: MatcherParams) -> list[_Cand]:
    """Brute-force point → edge candidates: the closest projection per
    edge, nearest first, at most ``max_candidates`` within the radius."""
    d, t, _ = point_segment_project(pt[None, :], ts.seg_a, ts.seg_b)
    best: dict[int, _Cand] = {}
    for s in np.argsort(d, kind="stable"):
        if d[s] > params.search_radius or len(best) >= params.max_candidates:
            break
        e = int(ts.seg_edge[s])
        if e not in best:
            off = float(ts.seg_off[s]) + float(t[s]) * float(ts.seg_len[s])
            best[e] = _Cand(edge=e, offset=off, dist=float(d[s]))
    return list(best.values())


def edge_dijkstra(ts: TileSet, e_from: int, bound: float,
                  ) -> dict[int, tuple[float, int]]:
    """Bounded Dijkstra: the distance from the END of ``e_from`` to the
    START of every edge within ``bound`` meters. → {edge: (dist,
    prev_edge)}, prev_edge -1 for a direct successor. A restricted tile
    searches edge space, honouring the bans of ``e_from`` and of every
    edge on the way; an unrestricted one searches nodes."""
    if ts.ban_set:
        return _edge_dijkstra_banned(ts, e_from, bound, ts.ban_set)
    out: dict[int, tuple[float, int]] = {}
    u0 = int(ts.edge_dst[e_from])
    dist: dict[int, float] = {u0: 0.0}
    prev_edge: dict[int, int] = {u0: -1}
    pq: list[tuple[float, int]] = [(0.0, u0)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist.get(u, np.inf):
            continue
        for e in ts.node_out[u]:
            if e < 0:
                break
            e = int(e)
            out.setdefault(e, (d, prev_edge[u]))
            nd = d + float(ts.edge_len[e])
            w = int(ts.edge_dst[e])
            if nd <= bound and nd < dist.get(w, np.inf):
                dist[w] = nd
                prev_edge[w] = e
                heapq.heappush(pq, (nd, w))
    return out


def _edge_dijkstra_banned(ts: TileSet, e_from: int, bound: float,
                          banned: "set[tuple[int, int]]",
                          ) -> dict[int, tuple[float, int]]:
    """edge_dijkstra on a restricted tile: the reach builder's edge-space
    search, seeded with the exits ``e_from`` may take."""
    seeds = [int(e) for e in ts.node_out[int(ts.edge_dst[e_from])]
             if e >= 0 and (e_from, int(e)) not in banned]
    targets = edge_space_targets(seeds, ts.node_out, ts.edge_dst,
                                 ts.edge_len, bound, banned)
    return {e: (d, prev) for e, (d, _first, prev) in targets.items()}


def walk_prev(reached: dict[int, tuple[float, int]], e2: int) -> list[int]:
    """The intermediate edges (exclusive) on the path to ``e2`` of a
    Dijkstra result, through its prev-edge pointers."""
    chain: list[int] = []
    e = e2
    while True:
        _, pe = reached[e]
        if pe < 0:
            break
        chain.append(pe)
        e = pe
    chain.reverse()
    return chain


def viterbi_bound(gc: float, params: MatcherParams) -> float:
    """A Dijkstra bound that covers every route the detour guard accepts."""
    return params.max_route_distance_factor * gc + 10.0 + 2000.0


class DijkstraCache:
    """Bound-aware memo of edge_dijkstra, shareable across traces.

    Re-using a larger bound is exact: the bound exceeds the detour guard
    (``route > factor * gc + 10`` is rejected) by 2 km, so the extra
    edges a larger search reaches carry routes the guard rejects anyway.
    Results depend only on the graph, so sharing across traces is exact
    too. Bounded: evicts the oldest half when full. Not thread-safe."""

    def __init__(self, max_edges: int = 4096):
        self._d: dict[int, tuple[float, dict]] = {}
        self.max_edges = max_edges
        self.searches = 0       # Dijkstra runs
        self.hits = 0

    def reached(self, ts: TileSet, edge: int, bound: float) -> dict:
        hit = self._d.get(edge)
        if hit is not None and hit[0] >= bound:
            self.hits += 1
            return hit[1]
        # over-search by 2x so slowly growing bounds do not thrash
        use = max(bound, 2.0 * hit[0] if hit else bound)
        reached = edge_dijkstra(ts, edge, use)
        self.searches += 1
        if edge not in self._d and len(self._d) >= self.max_edges:
            for k in list(self._d)[: self.max_edges // 2]:
                del self._d[k]
        self._d[edge] = (use, reached)
        return reached


def route_between(ts: TileSet, e1: int, o1: float, e2: int, o2: float,
                  bound: float, backward_slack: float,
                  ) -> tuple[float, list[int]]:
    """(route distance, intermediate edges e1 → e2 exclusive); inf when
    there is none within ``bound``."""
    if e1 == e2 and o2 >= o1 - backward_slack:
        return max(o2 - o1, 0.0), []
    reached = edge_dijkstra(ts, e1, bound)
    if e2 not in reached:
        return float("inf"), []
    gap, _ = reached[e2]
    dist = (float(ts.edge_len[e1]) - o1) + gap + o2
    return dist, walk_prev(reached, e2)


def interpolation_keep(xy: np.ndarray, interpolation_distance: float,
                       ) -> list[bool]:
    """The device decode's interpolation mask on the host: a point within
    ``interpolation_distance`` of the last kept point does not vote."""
    T = len(xy)
    keep = [True] * T
    if interpolation_distance <= 0.0 or not T:
        return keep
    last = None
    for t in range(T):
        if last is None:
            last = t
            continue
        if (float(np.linalg.norm(xy[t] - xy[last]))
                < interpolation_distance):
            keep[t] = False
        else:
            last = t
    return keep


def match_trace_cpu(ts: TileSet, xy: np.ndarray, params: MatcherParams,
                    dij_cache: DijkstraCache | None = None,
                    accuracy: "np.ndarray | None" = None,
                    ) -> list[tuple[int, float, bool]]:
    """Match one trace → per point (edge, offset, chain_start), edge -1
    where unmatched. One forward Viterbi pass with exact routing, then
    one backtrack per chain. ``dij_cache`` may be shared across traces of
    one tile. ``accuracy`` [T] (m): the emission sigma of point t is
    max(sigma_z, accuracy[t]), the rule the device path applies by
    scaling distances."""
    T = len(xy)
    cands = [find_candidates_cpu(ts, xy[t], params) for t in range(T)]
    results: list[tuple[int, float, bool]] = [(-1, 0.0, False)] * T
    INF = float("inf")

    def emit(c: _Cand, t: int) -> float:
        sigma = params.sigma_z
        if accuracy is not None:
            sigma = max(sigma, float(accuracy[t]))
        return c.dist ** 2 / (2.0 * sigma ** 2)

    keep = interpolation_keep(xy, params.interpolation_distance)

    # forward pass over the active points (kept, with candidates)
    if dij_cache is None:
        dij_cache = DijkstraCache()
    act = [t for t in range(T) if keep[t] and cands[t]]
    if not act:
        return results
    scores: dict[int, list[float]] = {}
    bps: dict[int, list[int]] = {}
    chain_started: dict[int, bool] = {}
    prev_t = -1
    for t in act:
        if prev_t < 0:
            scores[t] = [emit(c, t) for c in cands[t]]
            bps[t] = [-1] * len(cands[t])
            chain_started[t] = True
            prev_t = t
            continue
        gc = float(np.linalg.norm(xy[t] - xy[prev_t]))
        ns = [INF] * len(cands[t])
        bp = [-1] * len(cands[t])
        if gc <= params.breakage_distance:
            bound = viterbi_bound(gc, params)
            for j, cj in enumerate(cands[prev_t]):
                if scores[prev_t][j] == INF:
                    continue
                reached = dij_cache.reached(ts, cj.edge, bound)
                for k, ck in enumerate(cands[t]):
                    if (cj.edge == ck.edge
                            and ck.offset >= cj.offset - params.backward_slack):
                        route = max(ck.offset - cj.offset, 0.0)
                    elif ck.edge in reached:
                        route = ((float(ts.edge_len[cj.edge]) - cj.offset)
                                 + reached[ck.edge][0] + ck.offset)
                    else:
                        continue
                    if route > params.max_route_distance_factor * gc + 10.0:
                        continue
                    cost = scores[prev_t][j] + abs(route - gc) / params.beta
                    if cost < ns[k]:
                        ns[k] = cost
                        bp[k] = j
        if all(s == INF for s in ns):
            scores[t] = [emit(c, t) for c in cands[t]]
            bps[t] = [-1] * len(cands[t])
            chain_started[t] = True
        else:
            scores[t] = [s + emit(c, t) if s < INF else INF
                         for s, c in zip(ns, cands[t])]
            bps[t] = bp
            chain_started[t] = False
        prev_t = t

    # backtrack chain by chain from the last active point
    i = len(act) - 1
    while i >= 0:
        start = i
        while not chain_started[act[start]]:
            start -= 1
        chain_ts = act[start:i + 1]
        best = int(np.argmin(scores[chain_ts[-1]]))
        if scores[chain_ts[-1]][best] < INF:
            k = best
            for tt in reversed(chain_ts):
                c = cands[tt][k]
                results[tt] = (c.edge, c.offset, tt == chain_ts[0])
                k = bps[tt][k]
                if k < 0 and tt != chain_ts[0]:
                    break   # defensive: -1 only at the chain head
        i = start - 1

    # interpolated points ride the matched path (the device decode's fill
    # pass): they take the last matched point's location
    last: "tuple[int, float] | None" = None
    for t in range(T):
        e, off, _ = results[t]
        if e >= 0:
            last = (e, off)
        elif not keep[t] and last is not None:
            results[t] = (last[0], last[1], False)
    return results
