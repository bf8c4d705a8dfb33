"""Reach-table truncation audit.

Counterpart: reporter_tpu/tiles/reach_audit.py. The reach tables
(tiles/reach.py; the row governing transitions out of edge e is row
``edge_reach_row[e]``, a node row or, on a restricted tile, the
from-edge's private row) keep only the M nearest targets within
``reach_radius``; the device transition model (ops/hmm.route_distance)
treats everything else as unreachable. This module measures what that
costs on a workload: for every consecutive candidate pair the HMM would
consider, the exact bounded-Dijkstra verdict of the oracle
(matcher/cpu_reference.py, which searches edge space on a restricted
tile) against the table's, counting the transitions the table wrongly
rejects.

Pair-level misses overstate the harm (the Viterbi needs only one good
path), so step-level misses are reported too: transitions where the
table rejects every candidate pair the oracle accepts, forcing a
spurious chain break. ``summary()`` equals the JAX package's on the same
tile and traces.

    python -m reporter_tpu_torch.tiles.reach_audit [city] [n_traces]
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.matcher import cpu_reference
from reporter_tpu_torch.tiles.tileset import TileSet


@dataclass
class ReachAudit:
    """Counts from one audit run (see audit_reach)."""

    pairs_considered: int = 0      # candidate pairs with gc <= breakage
    pairs_accepted_exact: int = 0  # exact route exists & passes detour guard
    pairs_missed: int = 0          # accepted by exact, rejected by table
    steps_considered: int = 0      # consecutive active point pairs
    steps_accepted_exact: int = 0  # steps where exact accepts >= 1 pair
    steps_missed: int = 0          # exact accepts >= 1 pair, table accepts 0
    missed_gaps: list = field(default_factory=list)   # required end->start gap
    truncated_nodes: int = 0
    coverage_radii: np.ndarray | None = None  # per-node D_M (inf if untruncated)

    @property
    def pair_miss_rate(self) -> float:
        return self.pairs_missed / max(self.pairs_accepted_exact, 1)

    @property
    def step_miss_rate(self) -> float:
        return self.steps_missed / max(self.steps_accepted_exact, 1)

    def summary(self) -> dict:
        gaps = np.asarray(self.missed_gaps, np.float64)
        cov = self.coverage_radii
        fin = cov[np.isfinite(cov)] if cov is not None else np.empty(0)
        return {
            "pairs_considered": self.pairs_considered,
            "pairs_accepted_exact": self.pairs_accepted_exact,
            "pairs_missed": self.pairs_missed,
            "pair_miss_rate": round(self.pair_miss_rate, 5),
            "steps_considered": self.steps_considered,
            "steps_accepted_exact": self.steps_accepted_exact,
            "steps_missed": self.steps_missed,
            "step_miss_rate": round(self.step_miss_rate, 5),
            "missed_gap_m": {
                "min": round(float(gaps.min()), 1) if len(gaps) else None,
                "p50": round(float(np.median(gaps)), 1) if len(gaps) else None,
                "max": round(float(gaps.max()), 1) if len(gaps) else None,
            },
            "truncated_nodes": int(self.truncated_nodes),
            "node_coverage_m": {
                "min": round(float(fin.min()), 1) if len(fin) else None,
                "p50": round(float(np.median(fin)), 1) if len(fin) else None,
            },
        }


def node_coverage_radii(ts: TileSet) -> np.ndarray:
    """Per-row truncation coverage D_M: network distance of the farthest
    kept reach target (the radius beyond which the table is blind), +inf
    when the row is not full (nothing was cut). Schema-4 rows are laid out
    by target id, not distance, so this is a masked max."""
    full = ts.reach_to[:, -1] >= 0          # [N] row is full ⇒ maybe cut
    far = np.where(ts.reach_to >= 0, ts.reach_dist, -np.inf).max(axis=1)
    return np.where(full, far, np.inf)


def audit_reach(ts: TileSet, traces_xy: list[np.ndarray],
                params: MatcherParams | None = None,
                dij_cache: cpu_reference.DijkstraCache | None = None,
                ) -> ReachAudit:
    """Audit reach-table misses over a list of [T, 2] float traces.

    Mirrors the device transition model's acceptance rule
    (ops/hmm.py): a pair is accepted when a route exists and route <=
    max_route_distance_factor * gc + 10. Same-edge pairs moving forward
    (within backward_slack) are exact on the device (offset arithmetic, no
    table) and are skipped; same-edge backward pairs beyond the slack need
    a loop entry (e → its own start) in the reach row and are audited
    like any cross-edge pair.
    """
    params = params or MatcherParams()
    cache = dij_cache or cpu_reference.DijkstraCache()
    audit = ReachAudit()
    audit.truncated_nodes = int(ts.stats.get("reach_truncated_nodes", 0))
    audit.coverage_radii = node_coverage_radii(ts)

    reach_to = ts.reach_to
    reach_dist = ts.reach_dist
    edge_len = ts.edge_len

    for xy in traces_xy:
        xy = np.asarray(xy, np.float64)
        T = len(xy)
        cands = [cpu_reference.find_candidates_cpu(ts, xy[t], params)
                 for t in range(T)]
        keep = cpu_reference.interpolation_keep(
            xy, params.interpolation_distance)
        act = [t for t in range(T) if keep[t] and cands[t]]
        for prev_t, t in zip(act, act[1:]):
            gc = float(np.linalg.norm(xy[t] - xy[prev_t]))
            if gc > params.breakage_distance:
                continue
            limit = params.max_route_distance_factor * gc + 10.0
            bound = cpu_reference.viterbi_bound(gc, params)
            audit.steps_considered += 1
            step_exact = step_table = 0
            for cj in cands[prev_t]:
                reached = None
                row_to = row_d = None
                for ck in cands[t]:
                    if (cj.edge == ck.edge
                            and ck.offset >= cj.offset
                            - params.backward_slack):
                        continue   # same-edge forward: exact on device
                    audit.pairs_considered += 1
                    if reached is None:
                        reached = cache.reached(ts, cj.edge, bound)
                    hit = reached.get(ck.edge)
                    if hit is None:
                        continue
                    route = ((float(edge_len[cj.edge]) - cj.offset)
                             + hit[0] + ck.offset)
                    if route > limit:
                        continue
                    audit.pairs_accepted_exact += 1
                    step_exact += 1
                    if row_to is None:
                        u = int(ts.edge_reach_row[cj.edge])
                        row_to = reach_to[u]
                        row_d = reach_dist[u]
                    idx = np.nonzero(row_to == ck.edge)[0]
                    gap_t = float(row_d[idx[0]]) if len(idx) else np.inf
                    route_t = ((float(edge_len[cj.edge]) - cj.offset)
                               + gap_t + ck.offset)
                    if np.isfinite(gap_t) and route_t <= limit:
                        step_table += 1
                    else:
                        audit.pairs_missed += 1
                        audit.missed_gaps.append(hit[0])
            if step_exact:
                audit.steps_accepted_exact += 1
                if step_table == 0:
                    audit.steps_missed += 1
    return audit


def main(argv: list[str] | None = None) -> None:
    """CLI: python -m reporter_tpu_torch.tiles.reach_audit [city]
    [n_traces]; prints one JSON line, the JAX package's."""
    import json
    import sys

    from reporter_tpu_torch.config import CompilerParams
    from reporter_tpu_torch.netgen.synthetic import generate_city
    from reporter_tpu_torch.netgen.traces import synthesize_fleet
    from reporter_tpu_torch.tiles.compiler import compile_network

    args = list(sys.argv[1:] if argv is None else argv)
    city = args[0] if args else "sf"
    n = int(args[1]) if len(args) > 1 else 50
    ts = compile_network(generate_city(city), CompilerParams())
    fleet = synthesize_fleet(ts, n, num_points=120, seed=7)
    audit = audit_reach(ts, [p.xy for p in fleet])
    print(json.dumps({"city": city, "n_traces": n, **audit.summary()}))


if __name__ == "__main__":
    main()
