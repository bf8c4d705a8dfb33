"""The per-batch device program: candidates → Viterbi → result wire.

Counterpart: reporter_tpu/ops/match.py. ``match_traces`` runs the
candidate search (the dense sweep over the flattened [B*T] point batch,
or the grid backend's cell-row gather) and the batched Viterbi; the ``wire_from_*`` entries decode the three infeed forms (f32
points, i16 0.25 m quanta, i8 per-step deltas of those quanta) and pack
the result into ONE array, so it crosses to the host as one transfer.
``unpack_wire`` (numpy) is the host side.

Wire layouts (``unpack_wire`` dispatches on lane count / dtype):
  compact u16 [B, 2, T] — metros ≤ 16384 edges: lane 0 offset
    (0.25 m fixed point), lane 1 id(14) | start << 14 | matched << 15;
  packed  u32 [B, 1, T] — larger metros when ``wire_spec`` accepts:
    offset(ob) | edge(30-ob) | start << 30 | matched << 31;
  full    u16 [B, 3, T] — the fallback: lane 0 offset, lane 1 id low 16,
    lane 2 id hi(13) | start << 14 | matched << 15.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.ops.candidates import find_candidates
from reporter_tpu_torch.ops.dense_candidates import (CandidateSet,
                                                     find_candidates_dense)
from reporter_tpu_torch.ops.hmm import viterbi_decode_batched

OFFSET_QUANTUM = 0.25
_COMPACT_WIRE_EDGES = 1 << 14


class MatchOutput(NamedTuple):
    """Per-point match result (fixed [B, T] shapes; -1 = unmatched)."""

    edge: torch.Tensor         # i32
    offset: torch.Tensor       # f32
    chain_start: torch.Tensor  # bool
    matched: torch.Tensor      # bool


def _check_grid_coverage(params: MatcherParams, meta) -> None:
    """The single-cell gather covers the registration dilation only: a
    search radius past the tile's index_radius would drop roads."""
    if meta is None:
        raise ValueError("candidate_backend='grid' needs the tile's grid "
                         "metadata (meta=TileSet.meta)")
    if params.search_radius > meta.index_radius:
        raise ValueError(
            f"search_radius ({params.search_radius}) exceeds tile "
            f"index_radius ({meta.index_radius}); recompile tiles with "
            "index_radius >= radius")


def batch_candidates(points, valid_pt, tables, params: MatcherParams,
                     meta=None) -> CandidateSet:
    """Candidates for a batch of traces: points f32 [B, T, 2] → [B, T, K].

    ``params.candidate_backend``: "dense" (and "auto") runs one sweep over
    the flattened [B*T] point batch, in the kernel arm the params' sweep
    levers select; "grid" gathers each point's cell row of
    ``tables["cell_pack"]`` (every point, padding included, as the JAX
    package's does), with ``meta`` the tile's TileMeta (or GridMeta)."""
    B, T = points.shape[:2]
    backend = params.candidate_backend
    if backend == "grid":
        _check_grid_coverage(params, meta)
        return find_candidates(points, tables, meta, params.search_radius,
                               params.max_candidates)
    if backend not in ("auto", "dense"):
        raise ValueError(f"unknown candidate_backend {backend!r}; use "
                         "'auto', 'dense' or 'grid'")
    flat = find_candidates_dense(
        points.reshape(B * T, 2),
        (tables["seg_pack"], tables["seg_bbox"], tables["seg_sub"],
         tables["seg_feat"], tables["seg_sweep"], tables["seg_coarse"]),
        params.search_radius, params.max_candidates,
        valid=valid_pt.reshape(B * T), subcull=params.sweep_subcull,
        lowp=params.sweep_lowp, mxu=params.sweep_mxu)
    return CandidateSet(*(x.reshape(B, T, -1) for x in flat))


def match_traces(points, valid_pt, tables, params: MatcherParams,
                 acc_scale=None, meta=None) -> MatchOutput:
    """Match a batch: points f32 [B, T, 2], valid_pt bool [B, T].
    acc_scale f32 [B, T] (optional) scales candidate distances by
    sigma_z / max(sigma_z, accuracy): a per-point emission sigma. ``meta``
    is the tile's grid metadata (the grid backend's)."""
    cands = batch_candidates(points, valid_pt, tables, params, meta)
    if acc_scale is not None:
        cands = cands._replace(dist=cands.dist * acc_scale[..., None])
    vit = viterbi_decode_batched(
        cands, points, valid_pt, tables,
        params.sigma_z, params.beta, params.max_route_distance_factor,
        params.breakage_distance, params.backward_slack,
        params.interpolation_distance)
    return MatchOutput(edge=vit.edge, offset=vit.offset,
                       chain_start=vit.chain_start, matched=vit.matched)


def match_trace(points, valid_pt, tables, params: MatcherParams,
                meta=None) -> MatchOutput:
    """Match ONE padded trace: points f32 [T, 2], valid_pt bool [T] → a
    MatchOutput of [T] fields, through match_traces on a batch of one.
    The arguments keep this module's order (params before meta); the
    JAX package's is (..., meta, params)."""
    out = match_traces(points[None], valid_pt[None], tables, params,
                       meta=meta)
    return MatchOutput(*(x[0] for x in out))


def match_batch(points, valid_pt, tables, params: MatcherParams,
                meta=None) -> MatchOutput:
    """Match a batch: points f32 [B, T, 2], valid_pt bool [B, T]. The
    batch entry over match_traces (nothing is jitted here); the arguments
    keep this module's order (params before meta), where the JAX
    package's is (..., meta, params)."""
    return match_traces(points, valid_pt, tables, params, meta=meta)


def _valid(lengths, T: int):
    return (torch.arange(T, dtype=torch.int32, device=lengths.device)[None, :]
            < lengths[:, None])


def wire_from_f32(points, lengths, tables, params: MatcherParams,
                  acc_scale=None, spec=None, meta=None):
    """points f32 [B, T, 2], lengths i32 [B] (valid prefix per trace) →
    wire array; unpack with unpack_wire()."""
    out = match_traces(points, _valid(lengths, points.shape[1]), tables,
                       params, acc_scale, meta)
    return _pack_wire(out, tables["edge_len"].shape[0], spec)


def wire_from_q16(points_q, origins, lengths, tables, params: MatcherParams,
                  acc_scale=None, spec=None, meta=None):
    """points_q i16 [B, T, 2]: 0.25 m fixed-point offsets from per-trace
    origins f32 [B, 2]."""
    quantum = torch.full((), OFFSET_QUANTUM, dtype=torch.float32,
                             device=points_q.device)
    points = origins[:, None, :] + points_q.to(torch.float32) * quantum
    out = match_traces(points, _valid(lengths, points_q.shape[1]), tables,
                       params, acc_scale, meta)
    return _pack_wire(out, tables["edge_len"].shape[0], spec)


def wire_from_q8(deltas_q, origins, lengths, tables, params: MatcherParams,
                 acc_scale=None, spec=None, meta=None):
    """deltas_q i8 [B, T, 2]: per-step differences of the i16 quanta (first
    step 0). An integer cumsum rebuilds the i16 absolutes exactly, so this
    entry equals wire_from_q16 on every valid point."""
    q = torch.cumsum(deltas_q.to(torch.int32), dim=1, dtype=torch.int32)
    quantum = torch.full((), OFFSET_QUANTUM, dtype=torch.float32,
                             device=deltas_q.device)
    points = origins[:, None, :] + q.to(torch.float32) * quantum
    out = match_traces(points, _valid(lengths, deltas_q.shape[1]), tables,
                       params, acc_scale, meta)
    return _pack_wire(out, tables["edge_len"].shape[0], spec)


def wire_spec(num_edges: int, max_edge_len: float) -> "tuple | None":
    """Packed-u32 wire layout (ob offset bits, offset quantum q) for metros
    past the compact-u16 range, or None where the 3-lane u16 fallback must
    carry the result (q would exceed 0.5 m)."""
    if num_edges <= _COMPACT_WIRE_EDGES:
        return None                      # compact u16 is already 4 B/pt
    eb = max(15, int(np.ceil(np.log2(max(num_edges, 2)))))
    ob = 30 - eb
    if ob < 8:
        return None
    q = max(OFFSET_QUANTUM, float(max_edge_len) / ((1 << ob) - 1))
    return (ob, q) if q <= 0.5 else None


def _pack_wire(out: MatchOutput, num_edges: int, spec: "tuple | None" = None):
    """MatchOutput [B, T] → wire array (layouts in the module docstring).
    Bits are assembled in int64 and narrowed once at the end."""
    dev = out.edge.device
    edge = torch.clamp_min(out.edge, 0).to(torch.int64)
    start = out.chain_start.to(torch.int64)
    matched = out.matched.to(torch.int64)
    if spec is not None and num_edges > _COMPACT_WIRE_EDGES:
        ob, q = spec
        qt = torch.full((), q, dtype=torch.float32, device=dev)
        off_q = torch.clamp(torch.round(out.offset / qt), 0,
                            (1 << ob) - 1).to(torch.int64)
        w = off_q | (edge << ob) | (start << 30) | (matched << 31)
        return w[:, None, :].to(torch.uint32)
    qt = torch.full((), OFFSET_QUANTUM, dtype=torch.float32, device=dev)
    w0 = torch.clamp(torch.round(out.offset / qt), 0, 65535).to(torch.int64)
    if num_edges <= _COMPACT_WIRE_EDGES:
        w1 = (edge & 0x3FFF) | (start << 14) | (matched << 15)
        return torch.stack([w0, w1], dim=1).to(torch.uint16)
    w1 = edge & 0xFFFF
    w2 = ((edge >> 16) & 0x1FFF) | (start << 14) | (matched << 15)
    return torch.stack([w0, w1, w2], dim=1).to(torch.uint16)


def unpack_wire(wire, spec: "tuple | None" = None) -> tuple[Any, Any, Any]:
    """numpy unpack: u16 [B, 2|3, T] (or packed u32 [B, 1, T] with its
    ``spec`` from wire_spec) → (edges i32 [B,T] with -1 unmatched,
    offsets f32 [B,T], chain_starts bool [B,T])."""
    if wire.dtype == np.uint32:             # packed u32: off | edge | s | m
        if spec is None:
            raise ValueError(
                "unpack_wire: uint32 wire requires the wire_spec it was "
                "packed with (pass spec=wire_spec(...) from the matcher)")
        ob, q = spec
        w = np.asarray(wire[:, 0], np.int64)
        matched = (w >> 31) & 1
        edges = np.where(matched == 1,
                         (w >> ob) & ((1 << (30 - ob)) - 1), -1)
        starts = ((w >> 30) & 1).astype(bool)
        offsets = ((w & ((1 << ob) - 1)) * q).astype(np.float32)
        return edges.astype(np.int32), offsets, starts
    w0 = wire[:, 0].astype(np.int64)
    w1 = wire[:, 1].astype(np.int64)
    if wire.shape[1] == 2:                  # compact: id(14) | start | matched
        matched = (w1 >> 15) & 1
        edges = np.where(matched == 1, w1 & 0x3FFF, -1)
        starts = ((w1 >> 14) & 1).astype(bool)
    else:
        w2 = wire[:, 2].astype(np.int64)
        matched = (w2 >> 15) & 1
        edges = np.where(matched == 1, w1 | ((w2 & 0x1FFF) << 16), -1)
        starts = ((w2 >> 14) & 1).astype(bool)
    offsets = (w0 * OFFSET_QUANTUM).astype(np.float32)
    return edges.astype(np.int32), offsets, starts
