"""Host-side (NumPy) projections between (lon, lat) and tile-local meters.

Counterpart: reporter_tpu/geometry.py. Equirectangular with cos(lat0)
scaling around the tile origin — invertible and adequate at metro scale.
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
