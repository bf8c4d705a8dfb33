"""Host-side (NumPy) projections between (lon, lat) and tile-local meters.

Counterpart: reporter_tpu/geometry.py. Equirectangular with cos(lat0)
scaling around the tile origin — invertible and adequate at metro scale —
the point-to-segment projection the oracle's candidate search uses, a
polyline's length and the haversine distance.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_M = 6_371_008.8


def lonlat_to_xy(lonlat: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Project [..., 2] (lon, lat) degrees to local (x, y) meters around
    origin."""
    lonlat = np.asarray(lonlat, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    k = np.pi / 180.0 * EARTH_RADIUS_M
    x = (lonlat[..., 0] - origin[0]) * k * np.cos(np.deg2rad(origin[1]))
    y = (lonlat[..., 1] - origin[1]) * k
    return np.stack([x, y], axis=-1).astype(np.float64)


def xy_to_lonlat(xy: np.ndarray, origin: np.ndarray) -> np.ndarray:
    xy = np.asarray(xy, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    k = np.pi / 180.0 * EARTH_RADIUS_M
    lon = xy[..., 0] / (k * np.cos(np.deg2rad(origin[1]))) + origin[0]
    lat = xy[..., 1] / k + origin[1]
    return np.stack([lon, lat], axis=-1)


def point_segment_project(p: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Project points onto line segments, in f64. p, a, b: [..., 2],
    broadcastable. → (dist [...] to the closest point of [a, b], t [...]
    the clamped parameter in [0, 1], proj [..., 2] the closest point)."""
    p = np.asarray(p, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ab = b - a
    denom = np.maximum((ab * ab).sum(axis=-1), 1e-12)
    t = np.clip(((p - a) * ab).sum(axis=-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    dist = np.linalg.norm(p - proj, axis=-1)
    return dist, t, proj


def polyline_length(pts: np.ndarray) -> float:
    """Total length of an [n, 2] polyline, in f64."""
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def great_circle_m(lonlat_a: np.ndarray, lonlat_b: np.ndarray) -> np.ndarray:
    """Haversine distance in meters between [..., 2] (lon, lat) degree
    points."""
    a = np.deg2rad(np.asarray(lonlat_a, dtype=np.float64))
    b = np.deg2rad(np.asarray(lonlat_b, dtype=np.float64))
    dlat = b[..., 1] - a[..., 1]
    dlon = b[..., 0] - a[..., 0]
    h = (np.sin(dlat / 2) ** 2
         + np.cos(a[..., 1]) * np.cos(b[..., 1]) * np.sin(dlon / 2) ** 2)
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
