"""OSMLR segment export: the published segment definitions, as GeoJSON.

Counterpart: reporter_tpu/tiles/osmlr_export.py. Datastore consumers
resolve a report's ``segment_id`` back to a place on the map through
these definitions: one GeoJSON Feature per OSMLR segment, its geometry
stitched from the member edges' line segments in drive order, its
properties the stable id, the length and the source way ids. The file is
the JAX package's, byte for byte, for the same tile.

    python -m reporter_tpu_torch.tiles osmlr metro.npz -o segments.geojson
"""

from __future__ import annotations

import json

import numpy as np

from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.tiles.tileset import TileSet


def osmlr_features(ts: TileSet) -> "list[dict]":
    """GeoJSON Features (LineString per OSMLR segment), id order."""
    # member edges per row, ordered by their offset within the segment
    edges_of: dict[int, list[tuple[float, int]]] = {}
    for e in range(ts.num_edges):
        row = int(ts.edge_osmlr[e])
        if row >= 0:
            edges_of.setdefault(row, []).append(
                (float(ts.edge_osmlr_off[e]), e))

    # line segments per edge: the compiler emits them grouped by edge in
    # increasing seg_off order, so one forward pass groups them
    segs_of: dict[int, list[int]] = {}
    for s in range(len(ts.seg_edge)):
        segs_of.setdefault(int(ts.seg_edge[s]), []).append(s)

    origin = np.asarray(ts.meta.origin_lonlat)
    feats: list[dict] = []
    for row in range(len(ts.osmlr_id)):
        members = sorted(edges_of.get(row, ()))
        if not members:
            continue
        pts_xy: list = []
        way_ids: list[int] = []
        for _, e in members:
            w = int(ts.edge_way[e])
            if not way_ids or way_ids[-1] != w:
                way_ids.append(w)
            for s in segs_of.get(e, ()):
                ax, ay = float(ts.seg_a[s, 0]), float(ts.seg_a[s, 1])
                # consecutive seg_b / seg_a pairs are the same f32 values
                # by construction: an exact compare
                if not pts_xy or pts_xy[-1] != (ax, ay):
                    pts_xy.append((ax, ay))
                pts_xy.append((float(ts.seg_b[s, 0]),
                               float(ts.seg_b[s, 1])))
        if len(pts_xy) < 2:
            # every member edge was shorter than the decomposer keeps:
            # a LineString of fewer than 2 points is invalid GeoJSON
            continue
        lonlat = xy_to_lonlat(np.asarray(pts_xy, np.float64), origin)
        feats.append({
            "type": "Feature",
            "id": int(ts.osmlr_id[row]),
            "geometry": {
                "type": "LineString",
                "coordinates": [[round(float(lo), 7), round(float(la), 7)]
                                for lo, la in lonlat],
            },
            "properties": {
                "osmlr_id": int(ts.osmlr_id[row]),
                "length_m": round(float(ts.osmlr_len[row]), 2),
                "way_ids": way_ids,
                "num_edges": len(members),
            },
        })
    return feats


def export_osmlr_geojson(ts: TileSet, path: str) -> int:
    """Write the FeatureCollection; returns the feature count."""
    feats = osmlr_features(ts)
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection",
                   "name": f"{ts.name}-osmlr",
                   "features": feats}, f)
    return len(feats)
