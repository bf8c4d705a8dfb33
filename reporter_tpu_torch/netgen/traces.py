"""GPS probe-trace synthesis with ground truth.

Counterpart: reporter_tpu/netgen/traces.py. A random drive on the compiled
graph, sampled at fixed dt with Gaussian GPS noise; the same tile and seed
give the same probes as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.tiles.tileset import TileSet


@dataclass
class Probe:
    """One synthetic vehicle trace."""

    uuid: str
    lonlat: np.ndarray        # [T, 2] noisy (lon, lat)
    xy: np.ndarray            # [T, 2] noisy local meters
    times: np.ndarray         # [T] seconds (epoch-less)
    true_edges: np.ndarray    # [T] ground-truth edge id per sample
    true_offsets: np.ndarray  # [T] ground-truth distance along edge (m)
    path_edges: np.ndarray    # full driven edge sequence

    def to_report_json(self) -> dict:
        """The /report request shape: uuid + a list of {lat, lon, time}."""
        return {
            "uuid": self.uuid,
            "trace": [
                {"lat": float(la), "lon": float(lo), "time": float(t)}
                for (lo, la), t in zip(self.lonlat, self.times)
            ],
        }


class _EdgeShapeCache:
    """seg arrays grouped by edge, so sampling is O(1)-ish per lookup."""

    def __init__(self, ts: TileSet):
        order = np.argsort(ts.seg_edge, kind="stable")
        self.seg_by_edge_start = np.searchsorted(
            ts.seg_edge[order], np.arange(ts.num_edges))
        self.seg_by_edge_end = np.searchsorted(
            ts.seg_edge[order], np.arange(ts.num_edges), side="right")
        self.order = order
        self.ts = ts

    def point_at(self, e: int, off: float) -> np.ndarray:
        ts = self.ts
        sl = self.order[self.seg_by_edge_start[e]:self.seg_by_edge_end[e]]
        offs = ts.seg_off[sl]
        i = int(np.searchsorted(offs, off, side="right") - 1)
        i = max(0, min(i, len(sl) - 1))
        s = sl[i]
        t = np.clip((off - ts.seg_off[s]) / max(ts.seg_len[s], 1e-6), 0.0, 1.0)
        return ts.seg_a[s] + t * (ts.seg_b[s] - ts.seg_a[s])


def random_walk_edges(ts: TileSet, rng: np.random.Generator,
                      target_length: float) -> list[int]:
    """A plausible drive: follow graph connectivity and avoid immediate
    U-turns when an alternative exists."""
    e = int(rng.integers(ts.num_edges))
    path = [e]
    total = float(ts.edge_len[e])
    while total < target_length:
        u = int(ts.edge_dst[e])
        outs = [int(x) for x in ts.node_out[u] if x >= 0]
        if not outs:
            break
        non_uturn = [x for x in outs if x != int(ts.edge_opp[e])]
        choices = non_uturn if non_uturn else outs
        e = int(choices[rng.integers(len(choices))])
        path.append(e)
        total += float(ts.edge_len[e])
    return path


def synthesize_probe(
    ts: TileSet,
    seed: int = 0,
    *,
    num_points: int = 120,
    dt: float = 1.0,
    speed_mps: float | None = None,
    gps_sigma: float = 5.0,
    uuid: str | None = None,
    shape_cache: "_EdgeShapeCache | None" = None,
) -> Probe:
    """Drive a random path and sample noisy GPS points along it."""
    rng = np.random.default_rng(seed)
    speed = float(speed_mps if speed_mps is not None else rng.uniform(7.0, 16.0))
    need = speed * dt * (num_points + 2)
    path = random_walk_edges(ts, rng, need)
    cache = shape_cache if shape_cache is not None else _EdgeShapeCache(ts)

    cum = np.concatenate([[0.0], np.cumsum(ts.edge_len[path].astype(np.float64))])
    xs, true_e, true_off = [], [], []
    for i in range(num_points):
        s = min(i * dt * speed, cum[-1] - 1e-3)
        k = int(np.searchsorted(cum, s, side="right") - 1)
        k = max(0, min(k, len(path) - 1))
        off = s - cum[k]
        xs.append(cache.point_at(path[k], off))
        true_e.append(path[k])
        true_off.append(off)

    xy_true = np.asarray(xs, dtype=np.float64)
    noise = rng.normal(0.0, gps_sigma, size=xy_true.shape)
    xy = xy_true + noise
    lonlat = xy_to_lonlat(xy, np.asarray(ts.meta.origin_lonlat))
    times = np.arange(num_points, dtype=np.float64) * dt
    return Probe(
        uuid=uuid or f"veh-{seed}",
        lonlat=lonlat, xy=xy.astype(np.float64), times=times,
        true_edges=np.asarray(true_e, np.int32),
        true_offsets=np.asarray(true_off, np.float32),
        path_edges=np.asarray(path, np.int32),
    )


def synthesize_fleet(ts: TileSet, n: int, *, num_points: int = 120,
                     seed: int = 0, gps_sigma: float = 5.0) -> list[Probe]:
    cache = _EdgeShapeCache(ts)  # segment sort is per-TileSet, share it
    return [
        synthesize_probe(ts, seed=seed * 1_000_003 + i, num_points=num_points,
                         gps_sigma=gps_sigma, uuid=f"veh-{seed}-{i}",
                         shape_cache=cache)
        for i in range(n)
    ]
