"""Organic (non-grid) synthetic metro generator.

Counterpart: reporter_tpu/netgen/organic.py (``generate_organic_city``).
The same name, seed and sizes give the same RoadNetwork bit for bit: the
random draws are made in the same order from the same numpy generator, and
the scipy calls (Delaunay, minimum spanning tree, cKDTree) are the same.

The grid generator (netgen/synthetic.py) produces near-uniform degree-4
topology with ~120 m edges, which flatters Morton-block culling,
reach-table coverage and HMM disambiguation. This generator builds the
opposite: a radial city the shape real metros take,

  - node density falling off from a dense core to a sparse fringe, with
    angular "district" lobes (not rotationally uniform);
  - street topology from a Delaunay triangulation thinned by a
    radius-dependent length cap plus random pruning — mixed node degrees
    (3-way junctions dominate, like real cities), edge lengths from
    ~30 m downtown to ~2 km rural, nothing axis-aligned;
  - streets chained into multi-junction WAYS by straightest-continuation
    (the way named roads thread a city), so OSMLR segments span
    intersections like the reference's ~1 km references do;
  - ring + radial arterials SNAPPED onto existing streets (faster
    speeds, the way avenues emerge from a street fabric);
  - a limited-access highway spine crossing the metro: its own curved
    polyline, connected to the fabric only at ramp nodes, geometrically
    CROSSING many streets without sharing a node (overpasses);
  - cul-de-sac stubs (dead ends, the reach-table worst case);
  - one-ways and curved edge geometry like the grid generator.

Everything downstream (compiler, matcher, fleets) is source-agnostic.
"""

from __future__ import annotations

import numpy as np

from reporter_tpu_torch.netgen.network import RoadNetwork, Way

# speeds by road class (m/s)
_SPEED_LOCAL = 11.2
_SPEED_ARTERIAL = 17.9
_SPEED_SPINE = 29.0
_SPEED_RAMP = 13.4
_SPEED_STUB = 6.7


def _sample_nodes(rng: np.random.Generator, radius: float, core_scale: float,
                  n_candidates: int, dedupe_m: float) -> np.ndarray:
    """Poisson-like node cloud with 1/(1+(r/r0)^2) radial falloff and
    3-lobed angular districts; pairs closer than ``dedupe_m`` merged
    (keeps every edge length above the grid index's comfort floor and the
    core density inside cell_capacity)."""
    from scipy.spatial import cKDTree

    pts = rng.uniform(-radius, radius, size=(n_candidates, 2))
    r = np.linalg.norm(pts, axis=1)
    th = np.arctan2(pts[:, 1], pts[:, 0])
    density = 1.0 / (1.0 + (r / core_scale) ** 2)
    density *= np.clip(1.0 + 0.45 * np.cos(3.0 * th + 0.7), 0.1, None)
    keep = (r <= radius) & (rng.random(n_candidates) < density)
    pts = pts[keep]
    tree = cKDTree(pts)
    drop = np.zeros(len(pts), bool)
    for i, j in sorted(tree.query_pairs(dedupe_m)):
        if not drop[i] and not drop[j]:
            drop[max(i, j)] = True
    return pts[~drop]


def _street_edges(rng: np.random.Generator, pts: np.ndarray,
                  radius: float) -> np.ndarray:
    """Thinned Delaunay edges [K, 2]: a radius-dependent length cap (short
    blocks downtown, multi-km roads at the fringe), random pruning for
    mixed degrees, and the Delaunay MST kept unconditionally so the
    street fabric stays one connected component."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import Delaunay

    tri = Delaunay(pts)
    e = np.vstack([tri.simplices[:, [0, 1]], tri.simplices[:, [1, 2]],
                   tri.simplices[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    length = np.linalg.norm(pts[e[:, 0]] - pts[e[:, 1]], axis=1)

    mst = minimum_spanning_tree(coo_matrix(
        (length, (e[:, 0], e[:, 1])), shape=(len(pts), len(pts)))).tocoo()
    mst_keys = set(zip(*np.sort(np.vstack([mst.row, mst.col]), axis=0)))

    mid_r = np.linalg.norm((pts[e[:, 0]] + pts[e[:, 1]]) / 2.0, axis=1)
    max_len = 90.0 + 0.24 * mid_r
    keep = length <= max_len
    # prune preferentially the longer edges so junction degrees mix 3/4/5
    keep &= rng.random(len(e)) > 0.22 * (0.5 + length / max_len)
    keep |= np.fromiter(((a, b) in mst_keys for a, b in e), bool, len(e))
    return e[keep]


def _chain_ways(rng: np.random.Generator, pts: np.ndarray,
                edges: np.ndarray, arterial: np.ndarray,
                ) -> "list[tuple[list[int], bool]]":
    """Group street edges into multi-node way chains by straightest
    continuation within the same class (arterial/local): at each junction
    a chain continues onto the unvisited same-class edge that deviates
    least, if it deviates under ~50° — the way a named road threads
    junctions. Every edge lands in exactly one chain."""
    adj: dict[int, list[tuple[int, int]]] = {}
    for k, (a, b) in enumerate(edges):
        adj.setdefault(int(a), []).append((k, int(b)))
        adj.setdefault(int(b), []).append((k, int(a)))
    visited = np.zeros(len(edges), bool)

    def _extend(chain: list[int], cls: bool) -> None:
        while True:
            prev, cur = chain[-2], chain[-1]
            d0 = pts[cur] - pts[prev]
            d0 /= max(float(np.linalg.norm(d0)), 1e-9)
            best, best_cos = None, 0.64           # cos 50°
            for k2, other in adj.get(cur, ()):
                if visited[k2] or arterial[k2] != cls or other == prev:
                    continue
                d1 = pts[other] - pts[cur]
                d1 = d1 / max(float(np.linalg.norm(d1)), 1e-9)
                c = float(d0 @ d1)
                if c > best_cos:
                    best, best_cos = (k2, other), c
            if best is None:
                return
            visited[best[0]] = True
            chain.append(best[1])

    chains: list[tuple[list[int], bool]] = []
    order = rng.permutation(len(edges))
    for k in order:
        if visited[k]:
            continue
        visited[k] = True
        chain = [int(edges[k, 0]), int(edges[k, 1])]
        _extend(chain, bool(arterial[k]))
        chain.reverse()
        _extend(chain, bool(arterial[k]))
        chains.append((chain, bool(arterial[k])))
    return chains


def generate_organic_city(name: str = "organic", seed: int = 11,
                          radius: float = 9000.0, core_scale: float = 1800.0,
                          n_candidates: int = 150000,
                          center_lonlat: "tuple[float, float]" = (-122.27,
                                                                  37.80),
                          ) -> RoadNetwork:
    """Generate an organic metro RoadNetwork (~15k nodes / ~55k directed
    edges after compilation at the defaults)."""
    from reporter_tpu_torch.geometry import xy_to_lonlat

    rng = np.random.default_rng(seed)
    pts = _sample_nodes(rng, radius, core_scale, n_candidates, dedupe_m=32.0)
    edges = _street_edges(rng, pts, radius)

    r = np.linalg.norm(pts, axis=1)

    # ---- arterial classification (snapped onto existing streets) --------
    ring_radii = (1300.0, 2800.0, 4400.0)
    spoke_angles = rng.uniform(0.0, 2 * np.pi, size=7)
    a, b = edges[:, 0], edges[:, 1]
    is_ring = np.zeros(len(edges), bool)
    for rr in ring_radii:
        tol = 0.06 * rr + 60.0
        is_ring |= (np.abs(r[a] - rr) < tol) & (np.abs(r[b] - rr) < tol)
    is_spoke = np.zeros(len(edges), bool)
    for ang in spoke_angles:
        d = np.array([np.cos(ang), np.sin(ang)])
        ca = np.abs(pts[a] @ np.array([-d[1], d[0]]))
        cb = np.abs(pts[b] @ np.array([-d[1], d[0]]))
        on = (ca < 90.0) & (cb < 90.0) & (pts[a] @ d > 0) & (pts[b] @ d > 0)
        is_spoke |= on & (r[a] < 0.8 * radius)
    arterial = is_ring | is_spoke

    # ---- ways: straightest-continuation chains --------------------------
    chains = _chain_ways(rng, pts, edges, arterial)

    extra_xy: list[np.ndarray] = []      # spine/ramp/stub nodes appended
    ways: list[Way] = []
    way_id = 1

    def _xy_of(idx: int) -> np.ndarray:
        return pts[idx] if idx < len(pts) else extra_xy[idx - len(pts)]

    def _add_way(nodes: list[int], speed: float, nm: str,
                 oneway: bool, curved: bool = True) -> None:
        nonlocal way_id
        geometry: dict[int, np.ndarray] = {}
        if curved:
            # bow ~25% of long-enough legs (curved roads, like the grid gen)
            for leg in range(len(nodes) - 1):
                if rng.random() >= 0.25:
                    continue
                pa, pb = _xy_of(nodes[leg]), _xy_of(nodes[leg + 1])
                d = pb - pa
                n = float(np.linalg.norm(d))
                if n < 60.0:
                    continue
                perp = np.array([-d[1], d[0]]) / n
                mid = (pa + pb) / 2.0 + perp * rng.uniform(0.04, 0.1) * n
                geometry[leg] = xy_to_lonlat(
                    mid[None, :], np.asarray(center_lonlat, np.float64))
        ways.append(Way(way_id=way_id, nodes=nodes, oneway=oneway, name=nm,
                        speed_mps=speed, geometry=geometry))
        way_id += 1

    for chain, art in chains:
        if art:
            _add_way(chain, _SPEED_ARTERIAL, "avenue", False)
        else:
            _add_way(chain, _SPEED_LOCAL, "st",
                     bool(rng.random() < 0.22))

    # ---- highway spine (limited access, crosses streets as overpasses) --
    ang = rng.uniform(0.0, np.pi)
    d = np.array([np.cos(ang), np.sin(ang)])
    perp = np.array([-d[1], d[0]])
    spine_nodes: list[int] = []
    s = -radius * 0.98
    while s < radius * 0.98:
        off = 1200.0 * np.sin(s / radius * 2.2) + rng.normal(0.0, 60.0)
        p = s * d + off * perp
        if np.linalg.norm(p) < radius:
            spine_nodes.append(len(pts) + len(extra_xy))
            extra_xy.append(p)
        s += rng.uniform(600.0, 1400.0)      # long legs (0.6–1.4 km)
    if len(spine_nodes) >= 2:
        _add_way(spine_nodes, _SPEED_SPINE, "spine", False, curved=False)
        from scipy.spatial import cKDTree

        tree = cKDTree(pts)
        for sn in spine_nodes[::3]:          # a ramp every ~3 km
            p = _xy_of(sn)
            dists, nears = tree.query(p, k=4)
            # prefer a ramp with some length to it; fall back to the
            # closest street node rather than leaving the spine orphaned
            ok = [int(n) for dd, n in zip(dists, nears)
                  if 40.0 <= dd < 1500.0]
            target = ok[0] if ok else (int(nears[0])
                                       if dists[0] < 1500.0 else None)
            if target is not None:
                _add_way([sn, target], _SPEED_RAMP, "ramp", False,
                         curved=False)

    # ---- cul-de-sacs ----------------------------------------------------
    n_stub = max(1, len(pts) // 18)
    anchors = rng.choice(len(pts), size=n_stub, replace=False)
    for u in anchors:
        ang = rng.uniform(0.0, 2 * np.pi)
        stub = pts[u] + np.array([np.cos(ang), np.sin(ang)]) \
            * rng.uniform(40.0, 150.0)
        sid = len(pts) + len(extra_xy)
        extra_xy.append(stub)
        _add_way([int(u), sid], _SPEED_STUB, "cul", False, curved=False)

    all_xy = np.vstack([pts, np.asarray(extra_xy).reshape(-1, 2)]) \
        if extra_xy else pts
    node_ll = xy_to_lonlat(all_xy, np.asarray(center_lonlat, np.float64))
    return RoadNetwork(node_lonlat=node_ll, ways=ways, name=name)
