"""The grid candidate backend: each point's own cell row of the spatial grid.

Counterpart: reporter_tpu/ops/candidates.py. Registration was dilated by
``index_radius`` offline (tiles/compiler.py::_build_grid), so the one
cell row holding a point already lists every segment within a search
radius up to ``index_radius``. Each point gathers that row of
``cell_pack`` (tiles/tileset.py::build_cell_pack: the geometry of every
registered segment inline, [8*C] f32), measures its distance to all C
segments at once and keeps the K nearest distinct edges by K argmin
steps, masking every segment of a picked edge after each.

The JAX package vmaps one point's function over points and traces; here
every function takes a leading batch of points ([..., 2] → [..., K]).
The JAX grid path is jnp, not Pallas, but its K selection steps are a
lax.scan: on a card ``find_candidates`` is one launch of the
hand-written kernel ``kernels/grid.cu`` (bit-equal to the plain
version), on the CPU the plain version, ``_find_candidates_plain``,
whose scan is a Python loop of K steps.

Order: the steps rank slots by the squared distance, as the dense sweep
does, and a cell row lists its segments in segment order, which is edge
order, so the first minimal slot breaks a tie toward the smaller edge
id, also as the dense sweep does. The two backends then return the same
edge sets wherever their squared distances agree. The JAX grid ranks by
the rounded distance instead, and its square root maps neighbouring
squared distances to one value: where such a tie falls at the K-th
place, the JAX grid takes the smaller edge id and both dense sweeps (and
this port) the smaller squared distance (ROADMAP queue 3). The
arithmetic is the reference's, one rounding per operation: scalars are
0-d f32 tensors on the points' device (a true division, never a multiply
by a reciprocal), and the square root is correctly rounded
(``sqrt_f32``).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from reporter_tpu_torch.ops.dense_candidates import BIG, CandidateSet, sqrt_f32
from reporter_tpu_torch.tiles.tileset import (PACK_AX, PACK_AY, PACK_BX,
                                              PACK_BY, PACK_EDGE, PACK_LEN,
                                              PACK_NCOMP, PACK_OFF, TileMeta)

# Launches of the grid kernel, keyed by the top-K width K (a key appears
# at its first launch: readers take a missing key as 0). find_candidates
# adds one per launch on a card, under _LAUNCH_LOCK, and nothing else
# does; chip_smoke.py resets and reads them around each main-path run.
GRID_LAUNCHES: "dict[int, int]" = {}
_LAUNCH_LOCK = threading.Lock()


class GridMeta(NamedTuple):
    """The grid's geometry as scalars."""

    ox: float            # grid origin x (cell (0, 0)'s lower-left corner)
    oy: float            # grid origin y
    cell_size: float
    gw: int              # grid width in cells
    gh: int              # grid height in cells
    index_radius: float  # the registration dilation the grid was built with


def as_grid_meta(meta: "TileMeta | GridMeta") -> GridMeta:
    if isinstance(meta, GridMeta):
        return meta
    return GridMeta(ox=float(meta.grid_origin[0]),
                    oy=float(meta.grid_origin[1]),
                    cell_size=float(meta.cell_size),
                    gw=int(meta.grid_dims[0]), gh=int(meta.grid_dims[1]),
                    index_radius=float(meta.index_radius))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _point_segment_dist(px, py, ax, ay, bx, by):
    """Point-to-segment squared distance and projection parameter t in
    [0, 1], elementwise (structure of arrays); the distance is
    ``sqrt_f32`` of the first."""
    abx = bx - ax
    aby = by - ay
    denom = torch.maximum(abx * abx + aby * aby, _f32(1e-12, abx))
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
    dx = px - (ax + t * abx)
    dy = py - (ay + t * aby)
    return dx * dx + dy * dy, t


def gather_cell_pack(pts: torch.Tensor, cell_pack: torch.Tensor,
                     meta: "TileMeta | GridMeta"):
    """The fused segment data of the cell holding each point: pts f32
    [..., 2] → (ax, ay, bx, by, off, slen, edge), each [..., C]; edge -1
    marks an empty slot. A point outside the grid reads the nearest
    boundary cell, whose dilated registrations cover the first
    index_radius beyond the edge; the distance test rejects the rest."""
    gm = as_grid_meta(meta)
    cell_f = _f32(gm.cell_size, pts)

    def index(v, o, n):
        q = torch.floor((v - _f32(o, pts)) / cell_f)
        # clamped in float first: a far point's quotient may not fit i32
        return torch.clamp(q, -1.0, float(n)).to(torch.int64).clamp(0, n - 1)

    cell = (index(pts[..., 0], gm.ox, gm.gw) * gm.gh
            + index(pts[..., 1], gm.oy, gm.gh))
    row = cell_pack[cell].reshape(*cell.shape, PACK_NCOMP, -1)   # [..., 8, C]
    edge = row[..., PACK_EDGE, :].contiguous().view(torch.int32)
    return (row[..., PACK_AX, :], row[..., PACK_AY, :],
            row[..., PACK_BX, :], row[..., PACK_BY, :],
            row[..., PACK_OFF, :], row[..., PACK_LEN, :], edge)


def _topk_distinct_edges(seg_edges, keys, ts, k: int):
    """The K nearest distinct edges from per-slot ranking keys ([..., C]
    each, the squared distance; BIG = not a candidate): K steps, each
    taking the first minimal slot and then masking every slot of its
    edge, so an edge appears once (at its closest projection). → (edge,
    slot, t at the slot, picked), each [..., K]."""
    big = _f32(BIG, keys)
    c = keys.shape[-1]
    slots = torch.arange(c, device=keys.device)
    d = keys
    out_e, out_i, out_ok = [], [], []
    for _ in range(k):
        best = d.amin(dim=-1, keepdim=True)
        i = torch.clamp_max(torch.where(d == best, slots, c).amin(
            dim=-1, keepdim=True), c - 1)
        e = torch.gather(seg_edges, -1, i)
        ok = best < big
        d = torch.where(seg_edges == e, big, d)
        out_e.append(torch.where(ok, e, -1))
        out_i.append(torch.where(ok, i, 0))
        out_ok.append(ok)
    idx = torch.cat(out_i, dim=-1)
    return (torch.cat(out_e, dim=-1), idx, torch.gather(ts, -1, idx),
            torch.cat(out_ok, dim=-1))


def find_candidates(pts: torch.Tensor, tables, meta: "TileMeta | GridMeta",
                    search_radius: float, max_candidates: int
                    ) -> CandidateSet:
    """Candidates of a batch of points: pts f32 [..., 2] → CandidateSet
    with [..., K] fields. ``tables`` holds ``cell_pack``
    (tables_from_numpy(..., candidate_backend="grid")). On a card one
    launch of kernels/grid.cu (a failed build or launch raises); on the
    CPU the plain version; any other device raises."""
    dev = pts.device
    if dev.type == "cuda":
        return _find_candidates_cuda(pts, tables, meta, search_radius,
                                     max_candidates)
    if dev.type == "cpu":
        return _find_candidates_plain(pts, tables, meta, search_radius,
                                      max_candidates)
    raise ValueError(f"unsupported device {dev}")


def _find_candidates_plain(pts: torch.Tensor, tables,
                           meta: "TileMeta | GridMeta", search_radius: float,
                           max_candidates: int) -> CandidateSet:
    """The plain version (the CPU's, and what the kernel is held to on a
    card): the cell row's gather, the distances to all C slots at once,
    then ``_topk_distinct_edges``' K steps."""
    ax, ay, bx, by, off0, slen, seg_edge = gather_cell_pack(
        pts, tables["cell_pack"], meta)                        # [..., C]
    d2, t = _point_segment_dist(pts[..., 0:1], pts[..., 1:2],
                                ax, ay, bx, by)
    d = sqrt_f32(d2)
    big = _f32(BIG, d)
    seg_valid = (seg_edge >= 0) & (d <= _f32(search_radius, d))
    edges, idx, t_at, ok = _topk_distinct_edges(
        seg_edge, torch.where(seg_valid, d2, big), t, max_candidates)
    off = torch.gather(off0, -1, idx) + t_at * torch.gather(slen, -1, idx)
    return CandidateSet(
        edge=edges.to(torch.int32),
        offset=torch.where(ok, off, _f32(0.0, off)),
        dist=torch.where(ok, torch.gather(d, -1, idx), big),
        valid=ok)


def _find_candidates_cuda(pts: torch.Tensor, tables,
                          meta: "TileMeta | GridMeta", search_radius: float,
                          max_candidates: int) -> CandidateSet:
    """The grid candidates as one launch of kernels/grid.cu on the current
    stream of the points' card (a warp a point): allocates the four
    outputs, launches (``build.launch_grid`` checks the tensors) and
    counts the launch. Nothing here waits for the card."""
    from reporter_tpu_torch.kernels import build

    gm = as_grid_meta(meta)
    k = int(max_candidates)
    lead = tuple(pts.shape[:-1])
    flat = pts.reshape(-1, pts.shape[-1])
    n = int(flat.shape[0])
    dev = pts.device
    edge = torch.empty((n, k), dtype=torch.int32, device=dev)
    offset = torch.empty((n, k), dtype=torch.float32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    build.launch_grid(flat, tables["cell_pack"], gm.ox, gm.oy, gm.cell_size,
                      gm.gw, gm.gh, float(search_radius), edge, offset,
                      dist, valid)
    if n:
        with _LAUNCH_LOCK:
            GRID_LAUNCHES[k] = GRID_LAUNCHES.get(k, 0) + 1
    return CandidateSet(*(x.reshape(*lead, k)
                          for x in (edge, offset, dist, valid)))


def find_candidates_trace(points: torch.Tensor, tables,
                          meta: "TileMeta | GridMeta", search_radius: float,
                          max_candidates: int) -> CandidateSet:
    """[T, 2] points → CandidateSet with [T, K] fields (the JAX package's
    per-trace entry; ``find_candidates`` takes any leading shape)."""
    return find_candidates(points, tables, meta, search_radius,
                           max_candidates)
