"""Segment-sharded candidate search: the framework's tensor-parallel
analog.

Counterpart: reporter_tpu/parallel/sharded_candidates.py. The
Morton-blocked segment table is split over a mesh axis in whole
512-column blocks; every device sweeps its shard of the map against its
slice of the point batch, the per-shard top-K lists are gathered to one
device and merged with the sweep's own distinct-edge K-merge, and the
Viterbi runs once per slice of the other axis on the merged candidates
(the per-edge and reach tables replicated: node-keyed and small next to
the shape data).

Each shard stages the port's two derived tables as well, ``seg_sweep``
and ``seg_coarse``, built from that shard's own columns and block rows
(``_sweep_table``, ``_coarse_table``, ``_filter_table``), never sliced
out of the unsharded ones. Padding takes the reference's fills: pack
columns the bit pattern of edge = -1, bbox and slice rows NaN (a padded
block is never hit), feature rows BIG.

Segments of one edge may straddle a shard boundary; the merge keeps each
edge's closer projection with the sweep's own distance-tie resolution
(``_select_topk``: smallest tied edge id, then its lowest tied offset),
on the squared distances each shard's sweep returns (``squared=True``),
the key the unsharded sweep orders by; the square root is taken after
the merge, as the kernel takes it. So the candidates equal the unsharded
sweep's bit for bit, ties included. (The reference merges the rounded
distances: two directions of one street, whose squared distances differ
by an ulp, can share a rounded distance and then swap places there.)

Traffic per batch: one gather of [shards, points, K] triples, shards x
points x K x 12 bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.ops.dense_candidates import (BIG, SP_EDGE, _SBLK,
                                                     CandidateSet,
                                                     _coarse_table,
                                                     _filter_table,
                                                     _select_topk,
                                                     _sweep_table,
                                                     build_seg_pack,
                                                     find_candidates_dense,
                                                     root_dist)
from reporter_tpu_torch.ops.hmm import viterbi_decode_batched
from reporter_tpu_torch.ops.match import MatchOutput
from reporter_tpu_torch.parallel.dp import as_tensor, gather
from reporter_tpu_torch.parallel.dp_e2e import _row_blocks
from reporter_tpu_torch.parallel.mesh import Mesh
from reporter_tpu_torch.tiles.reach import check_rows_ascending
from reporter_tpu_torch.tiles.tileset import place_tables

# the six segment tables each shard stages, in find_candidates_dense's order
SEG_KEYS = ("seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
            "seg_coarse")
# replicated on every device that merges and decodes
ROUTE_KEYS = ("edge_len", "reach_row", "reach_to", "reach_dist")


class ShardedTables(NamedTuple):
    host: "list[dict[str, np.ndarray]]"   # per shard: its SEG_KEYS tables
    segments: "dict[tuple[int, torch.device], dict[str, torch.Tensor]]"
    #                                       (shard, device) → placed tables
    route: "dict[torch.device, dict[str, torch.Tensor]]"   # ROUTE_KEYS
    grid: np.ndarray                      # devices as [shards, other axis]


def _axis_grid(mesh: Mesh, axis: str) -> np.ndarray:
    if axis not in mesh.axis_names:
        raise ValueError(f"unknown mesh axis {axis!r}; one of "
                         f"{mesh.axis_names}")
    return mesh.devices if axis == "tile" else mesh.devices.T


def shard_host_tables(ts, n: int) -> "list[dict[str, np.ndarray]]":
    """The segment pack padded to n x whole-block shards, and each
    shard's six tables built from its own columns and blocks."""
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    spad = sp.pack.shape[1]
    per = -(-spad // (n * _SBLK)) * _SBLK          # columns per shard
    total = per * n
    pack = np.full((sp.pack.shape[0], total), np.int32(-1).view(np.float32),
                   np.float32)
    pack[:, :spad] = sp.pack
    bbox = np.full((total // _SBLK, 4), np.nan, np.float32)
    bbox[:sp.bbox.shape[0]] = sp.bbox
    sub = np.full((total // _SBLK, sp.sub.shape[1]), np.nan, np.float32)
    sub[:sp.sub.shape[0]] = sp.sub
    # feature rows pad in whole blocks whose NaN slice quads gate them
    # off; BIG keeps a stray read conservative
    feat = np.full((sp.feat.shape[0], total), np.float32(BIG), np.float32)
    feat[:, :spad] = sp.feat
    real = int((sp.pack[SP_EDGE].view(np.int32) >= 0).sum())   # a prefix
    nb = per // _SBLK
    out = []
    for i in range(n):
        cols = slice(i * per, (i + 1) * per)
        blks = slice(i * nb, (i + 1) * nb)
        p = np.ascontiguousarray(pack[:, cols])
        f = np.ascontiguousarray(feat[:, cols])
        q = np.ascontiguousarray(sub[blks])
        quads = q.reshape(-1, 4)
        half = np.float32(0.5)
        centers = np.stack([(quads[:, 0] + quads[:, 2]) * half,
                            (quads[:, 1] + quads[:, 3]) * half], axis=1)
        nreal = int(np.clip(real - i * per, 0, per))
        out.append({
            "seg_pack": p, "seg_bbox": np.ascontiguousarray(bbox[blks]),
            "seg_sub": q, "seg_feat": f, "seg_sweep": _sweep_table(p),
            "seg_coarse": np.ascontiguousarray(np.concatenate(
                [_coarse_table(f, centers, nb),
                 _filter_table(p, quads, nreal, nb)], axis=1))})
    return out


def shard_tables(mesh: Mesh, ts, axis: str = "tile") -> ShardedTables:
    """The segment tables sharded over ``axis`` (shard i on every device
    of index i along it), the route tables on the devices that merge
    (the first along ``axis``)."""
    grid = _axis_grid(mesh, axis)
    host = shard_host_tables(ts, grid.shape[0])
    segments = {}
    for i, row in enumerate(grid):
        for dev in dict.fromkeys(row):
            segments[i, dev] = place_tables(host[i], dev)
    arrays = ts.arrays()
    check_rows_ascending(arrays["reach_to"])
    route_host = {"edge_len": arrays["edge_len"],
                  "reach_row": arrays["edge_reach_row"],
                  "reach_to": arrays["reach_to"],
                  "reach_dist": arrays["reach_dist"]}
    route = {dev: place_tables(route_host, dev)
             for dev in dict.fromkeys(grid[0])}
    return ShardedTables(host, segments, route, grid)


def _merge_topk(edge, d2, off, k: int):
    """Merge gathered per-shard K-lists: fields [shards, N, K] → [N, K],
    on the squared distances ``d2`` (BIG where empty), → (edge, d2,
    offset). Delegates to the sweep's ``_select_topk``, so the
    distinct-edge K-merge and its distance-tie resolution are one
    implementation: exact ties at high-degree junctions can span shard
    boundaries."""
    s, n, kk = edge.shape
    e = edge.permute(1, 0, 2).reshape(n, s * kk)
    d = d2.permute(1, 0, 2).reshape(n, s * kk)
    o = off.permute(1, 0, 2).reshape(n, s * kk)
    d = torch.where(e >= 0, d, torch.full((), BIG, dtype=d.dtype,
                                              device=d.device))
    md, me, mo = _select_topk(d, e, o, k)
    return me, md, mo


def sharded_candidates(tables: ShardedTables, points, valid,
                       params: MatcherParams, j: int = 0):
    """Candidates of flat points [N, 2] (valid [N]) against every
    segment shard, each on its device in slice ``j`` of the other axis
    (squared distances), merged on that slice's first device → (edge,
    dist, offset) [N, K]."""
    grid = tables.grid
    lists = []
    for i in range(grid.shape[0]):
        dev = grid[i, j]
        tb = tables.segments[i, dev]
        lists.append(find_candidates_dense(
            as_tensor(points, dev), tuple(tb[key] for key in SEG_KEYS),
            params.search_radius, params.max_candidates,
            valid=as_tensor(valid, dev), subcull=params.sweep_subcull,
            lowp=params.sweep_lowp, mxu=params.sweep_mxu, squared=True))
    mdev = grid[0, j]
    me, md2, mo = _merge_topk(*(torch.stack([getattr(f, fld).to(mdev)
                                             for f in lists])
                                for fld in ("edge", "dist", "offset")),
                              params.max_candidates)
    return me, root_dist(md2), mo


def make_sharded_matcher(mesh: Mesh, ts, params: MatcherParams,
                         axis: str = "tile"):
    """→ step(points [B, T, 2], valid [B, T]) → MatchOutput [B, T] on the
    mesh's first device, with the segment table sharded over ``axis``
    (map-capacity scaling) and the batch over the other axis (B a
    multiple of its size). ``step.tables`` is the ShardedTables."""
    tables = shard_tables(mesh, ts, axis)
    grid = tables.grid
    k = params.max_candidates

    def step(points, valid) -> MatchOutput:
        B, T = points.shape[:2]
        if B % grid.shape[1]:
            raise ValueError(f"batch of {B} rows is not a multiple of the "
                             f"{grid.shape[1]} slices of the other axis")
        parts = []
        for j, rows in enumerate(_row_blocks(B, grid.shape[1])):
            b = rows.stop - rows.start
            me, md, mo = sharded_candidates(
                tables, points[rows].reshape(b * T, 2),
                valid[rows].reshape(b * T), params, j)
            cands = CandidateSet(edge=me.reshape(b, T, k),
                                 offset=mo.reshape(b, T, k),
                                 dist=md.reshape(b, T, k),
                                 valid=(me >= 0).reshape(b, T, k))
            mdev = grid[0, j]
            vit = viterbi_decode_batched(
                cands, as_tensor(points[rows], mdev),
                as_tensor(valid[rows], mdev), tables.route[mdev],
                params.sigma_z, params.beta,
                params.max_route_distance_factor, params.breakage_distance,
                params.backward_slack, params.interpolation_distance)
            parts.append(MatchOutput(edge=vit.edge, offset=vit.offset,
                                     chain_start=vit.chain_start,
                                     matched=vit.matched))
        return gather(parts, grid[0, 0])

    step.tables = tables
    return step
