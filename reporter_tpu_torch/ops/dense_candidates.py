"""Dense candidate search: the segment sweep, as a CUDA kernel on the card
and as plain PyTorch on the CPU.

Counterpart: reporter_tpu/ops/dense_candidates.py. For every probe point
the top-K *distinct* edges within ``radius``, each edge represented by its
closest projection: ordered by (d², edge id), ties broken toward the
smallest edge id, the offset being that edge's smallest tied projection.

- ``build_seg_pack`` Morton-sorts the line segments into 512-column blocks
  of [8, S_pad] f32 component rows (edge ids bit-cast into row 6) with
  per-block and per-128-column-slice bboxes — byte-equal to the JAX
  package's pack.
- ``_dense_plain`` is the full sweep without culling (the JAX package's
  ``_dense_jnp``), chunked over 128 points. The CPU path and the tests use
  it; ``chip_smoke.py`` holds the kernel against it on the card.
- ``find_candidates_dense`` on a CUDA tensor runs the cull pre-pass
  (``_chunk_block_ids``, plain PyTorch) and then ``sweep_topk``, the
  wrapper of the hand-written kernel in ``kernels/sweep.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG = 1e30

# seg_pack component rows
SP_AX, SP_AY, SP_BX, SP_BY, SP_OFF, SP_LEN, SP_EDGE, SP_SPARE = range(8)
SP_NCOMP = 8

_P = 256          # points per chunk: one CUDA thread block, one thread a point
_SBLK = 512       # segment columns per block (the culling unit)
_SUB = 128        # columns per slice of the kernel's second culling level
_NSUB = 8         # sub-bboxes per chunk in the pre-pass (32 points each)
_PLAIN_P = 128    # points per chunk of the plain sweep (bounds its [P, S] temporaries)
SPLIT_LEN = 256.0  # long-segment pre-split span
SWEEP_K = 8       # the top-K width the kernel is built for

# Launches of the CUDA sweep on the main path, per arm. sweep_topk adds one
# per kernel launch and nothing else does; chip_smoke.py resets and reads
# them around the main-path run.
SWEEP_LAUNCHES = {"sub": 0, "block": 0}


class CandidateSet(NamedTuple):
    """Per-point candidate fields ([..., K]; edge -1 = empty slot)."""

    edge: torch.Tensor     # i32
    offset: torch.Tensor   # f32 distance along the edge (m)
    dist: torch.Tensor     # f32 point-to-edge distance (m), BIG when empty
    valid: torch.Tensor    # bool


class SegPack(NamedTuple):
    """Dense segment table (spatially blocked), host numpy arrays."""

    pack: np.ndarray   # f32 [8, S_pad] component rows, Morton-sorted columns
    bbox: np.ndarray   # f32 [nblocks, 4] per-block (xmin, ymin, xmax, ymax)
    sub: np.ndarray    # f32 [nblocks, (SBLK/SUB)*4] per-slice bbox quads,
    #                    NaN for a slice with no real column


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device, as CUDA's sqrtf
    and the kernel's are. PyTorch's vectorized CPU sqrt is not (a fraction
    of a percent of f32 inputs come out one ulp off, in f64 too), so a
    first guess y is moved to a neighbour when x falls outside the squares
    of the midpoints around y — those squares are exact in f64."""
    y = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    lo = torch.nextafter(y, torch.zeros_like(y))
    hi = torch.nextafter(y, torch.full_like(y, float("inf")))
    xd, yd = x.to(torch.float64), y.to(torch.float64)
    m_lo = (lo.to(torch.float64) + yd) * 0.5
    m_hi = (yd + hi.to(torch.float64)) * 0.5
    return torch.where(xd < m_lo * m_lo, lo,
                       torch.where(xd > m_hi * m_hi, hi, y))


def _morton(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Interleave 16-bit quantized coords → 32-bit Morton keys."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    return spread(x) | (spread(y) << np.uint64(1))


def _split_long_segments(seg_a, seg_b, seg_edge, seg_off, seg_len,
                         lmax: float):
    """Tile segments longer than ``lmax`` into collinear sub-spans, so one
    long edge does not inflate a block's bbox. Piece r of parent i spans
    fractions [r/n_i, (r+1)/n_i]; the final piece ends at the original
    endpoint bit for bit (junction d=0 ties must stay exact)."""
    long_i = np.nonzero(seg_len > lmax)[0]
    if not len(long_i):
        return seg_a, seg_b, seg_edge, seg_off, seg_len
    keep = np.ones(len(seg_len), bool)
    keep[long_i] = False
    n = np.ceil(seg_len[long_i] / lmax).astype(np.int64)
    parent = np.repeat(long_i, n)                      # [N] parent index
    r = np.arange(len(parent)) - np.repeat(np.cumsum(n) - n, n)
    nn = np.repeat(n, n).astype(np.float64)
    f0 = (r / nn)[:, None]
    f1 = ((r + 1) / nn)[:, None]
    d = seg_b[parent] - seg_a[parent]
    pb_long = seg_a[parent] + d * f1
    last = (r + 1) == nn.astype(np.int64)
    pb_long[last] = seg_b[parent[last]]
    return (np.concatenate([seg_a[keep],
                            seg_a[parent] + d * f0]).astype(np.float32),
            np.concatenate([seg_b[keep], pb_long]).astype(np.float32),
            np.concatenate([seg_edge[keep], seg_edge[parent]]),
            np.concatenate([seg_off[keep], seg_off[parent]
                            + seg_len[parent] * f0[:, 0]]).astype(np.float32),
            np.concatenate([seg_len[keep], seg_len[parent]
                            * (f1 - f0)[:, 0]]).astype(np.float32))


def build_seg_pack(seg_a: np.ndarray, seg_b: np.ndarray, seg_edge: np.ndarray,
                   seg_off: np.ndarray, seg_len: np.ndarray,
                   block: int = _SBLK, split_len: float = SPLIT_LEN) -> SegPack:
    """Morton-sort segments, pack [8, S_pad] f32 component rows (edge ids
    bit-cast into a row), record per-block and per-slice bboxes. Padding
    columns carry edge = -1; padding blocks and all-padding slices carry
    NaN boxes, which every culling comparison rejects."""
    if split_len and len(seg_len):
        seg_a, seg_b, seg_edge, seg_off, seg_len = _split_long_segments(
            seg_a, seg_b, seg_edge, seg_off, seg_len, split_len)
    s = len(seg_edge)
    spad = max(block, ((s + block - 1) // block) * block)

    mid = (seg_a + seg_b) * 0.5 if s else np.zeros((0, 2))
    if s:
        lo = mid.min(0)
        span = np.maximum(mid.max(0) - lo, 1e-6)
        q = np.minimum((mid - lo) / span * 65535.0, 65535.0).astype(np.uint32)
        order = np.argsort(_morton(q[:, 0], q[:, 1]), kind="stable")
    else:
        order = np.arange(0)
    a, b = seg_a[order], seg_b[order]

    pack = np.zeros((SP_NCOMP, spad), np.float32)
    pack[SP_AX, :s] = a[:, 0]
    pack[SP_AY, :s] = a[:, 1]
    pack[SP_BX, :s] = b[:, 0]
    pack[SP_BY, :s] = b[:, 1]
    pack[SP_OFF, :s] = seg_off[order]
    pack[SP_LEN, :s] = seg_len[order]
    edge = np.full(spad, -1, np.int32)
    edge[:s] = seg_edge[order]
    pack[SP_EDGE] = edge.view(np.float32)

    nblocks = spad // block
    bbox = np.full((nblocks, 4), np.nan, np.float32)
    for blk in range(nblocks):
        sl = slice(blk * block, min((blk + 1) * block, s))
        if sl.start >= s:
            break
        xs = np.concatenate([a[sl, 0], b[sl, 0]])
        ys = np.concatenate([a[sl, 1], b[sl, 1]])
        bbox[blk] = (xs.min(), ys.min(), xs.max(), ys.max())

    nsub = block // _SUB if _SUB and block % _SUB == 0 else 1
    subw = block // nsub
    real = np.arange(spad) < s
    big = np.float32(np.inf)
    cxmin = np.where(real, np.minimum(pack[SP_AX], pack[SP_BX]), big)
    cymin = np.where(real, np.minimum(pack[SP_AY], pack[SP_BY]), big)
    cxmax = np.where(real, np.maximum(pack[SP_AX], pack[SP_BX]), -big)
    cymax = np.where(real, np.maximum(pack[SP_AY], pack[SP_BY]), -big)
    quads = np.stack([cxmin.reshape(-1, subw).min(1),
                      cymin.reshape(-1, subw).min(1),
                      cxmax.reshape(-1, subw).max(1),
                      cymax.reshape(-1, subw).max(1)], axis=1)
    quads[~real.reshape(-1, subw).any(1)] = np.nan
    sub = quads.astype(np.float32).reshape(nblocks, nsub * 4)
    return SegPack(pack=pack, bbox=bbox, sub=sub)


def cull_radius(radius: float) -> float:
    """The slice cull's dilated radius: absorbs f32 rounding of the
    point-to-bbox lower bound, so the cull never drops a pair the exact
    r² test would keep."""
    return float(radius) * 1.0005 + 0.01


def _block_geometry(px, py, seg):
    """Distances/offsets of a [P,1] point column against a [8, C] segment
    block → (d2 [P,C], edge [P,C] i32, offabs [P,C]). Every operation is a
    separate rounding in the JAX reference's order (the kernel repeats it
    with contraction off)."""
    ax = seg[SP_AX:SP_AX + 1, :]
    ay = seg[SP_AY:SP_AY + 1, :]
    bx = seg[SP_BX:SP_BX + 1, :]
    by = seg[SP_BY:SP_BY + 1, :]
    off0 = seg[SP_OFF:SP_OFF + 1, :]
    slen = seg[SP_LEN:SP_LEN + 1, :]
    edge = seg[SP_EDGE:SP_EDGE + 1, :].view(torch.int32)

    abx = bx - ax
    aby = by - ay
    denom = torch.clamp_min(abx * abx + aby * aby, 1e-12)
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
    dx = px - (ax + t * abx)
    dy = py - (ay + t * aby)
    d2 = dx * dx + dy * dy
    offabs = off0 + t * slen
    return d2, edge.expand_as(d2), offabs


def _select_topk(d2, edge, offabs, k: int):
    """K passes of (global min, smallest tied edge, that edge's smallest
    tied offset, kill that edge's columns): d2 [P, C] (BIG = invalid) →
    (d2 [P, K], edge [P, K], offabs [P, K])."""
    big_e = torch.tensor(2 ** 31 - 1, dtype=torch.int32, device=d2.device)
    big = torch.tensor(BIG, dtype=d2.dtype, device=d2.device)
    outs_d, outs_e, outs_o = [], [], []
    for _ in range(k):
        m = d2.amin(dim=1, keepdim=True)                           # [P,1]
        tied = d2 == m
        pick_e = torch.where(tied, edge, big_e).amin(dim=1)        # [P]
        sel = tied & (edge == pick_e[:, None])
        o_k = torch.where(sel, offabs, big).amin(dim=1)
        ok = m[:, 0] < BIG
        outs_d.append(m[:, 0])
        outs_e.append(torch.where(ok, pick_e, -1))
        outs_o.append(torch.where(ok, o_k, 0.0))
        d2 = torch.where((edge == pick_e[:, None]) & ok[:, None], big, d2)
    return (torch.stack(outs_d, 1), torch.stack(outs_e, 1).to(torch.int32),
            torch.stack(outs_o, 1))


def _dense_plain(points: torch.Tensor, pack: torch.Tensor, radius: float,
                 k: int):
    """The plain version: full sweep, no culling, blocked over 128-point
    chunks → (edge i32 [N,K], offset f32 [N,K], dist f32 [N,K])."""
    n = points.shape[0]
    nchunks = max(1, -(-n // _PLAIN_P))
    npad = nchunks * _PLAIN_P
    pts = torch.nn.functional.pad(points, (0, 0, 0, npad - n))
    r2 = float(radius) * float(radius)
    big = torch.tensor(BIG, dtype=torch.float32, device=points.device)
    es, os_, ds = [], [], []
    for c in range(nchunks):
        p = pts[c * _PLAIN_P:(c + 1) * _PLAIN_P]
        d2, edge, offabs = _block_geometry(p[:, 0:1], p[:, 1:2], pack)
        d2 = torch.where((edge >= 0) & (d2 <= r2), d2, big)
        d, e, o = _select_topk(d2, edge, offabs, k)
        ds.append(d)
        es.append(e)
        os_.append(o)
    d2c = torch.cat(ds)[:n]
    dist = torch.where(d2c < BIG, sqrt_f32(torch.clamp_min(d2c, 0.0)), big)
    return torch.cat(es)[:n], torch.cat(os_)[:n], dist


def _fill_invalid(points: torch.Tensor, valid: torch.Tensor, nchunks: int):
    """Pad to whole 256-point chunks and replace every invalid point with
    its chunk's masked mean, so padding culls like its chunk (a zero would
    drag the chunk's bbox to the origin). → (pts [npad,2], valid [npad])."""
    n = points.shape[0]
    npad = nchunks * _P
    pts = torch.nn.functional.pad(points, (0, 0, 0, npad - n))
    val = torch.nn.functional.pad(valid, (0, npad - n))
    chunks = pts.reshape(nchunks, _P, 2)
    vc = val.reshape(nchunks, _P, 1)
    cnt = torch.clamp_min(vc.sum(dim=1, dtype=torch.int32), 1)
    mean = torch.where(vc, chunks, 0.0).sum(dim=1) / cnt
    pts = torch.where(vc, chunks, mean[:, None, :]).reshape(npad, 2)
    return pts.contiguous(), val


def _chunk_block_ids(pts, valid, bbox, radius: float, nchunks: int):
    """Culling pre-pass → (ids i32 [nchunks, nblocks] with each chunk's hit
    blocks first in ascending order, nhits i32 [nchunks]).

    Each chunk is split into _NSUB runs of 32 points; a block is a hit if
    its bbox overlaps any run's valid-point bbox dilated by ``radius``.
    NaN (padding) block boxes never hit. Slots past nhits are 0 and never
    read: the kernel walks only its own hit list."""
    sub = pts.reshape(nchunks * _NSUB, _P // _NSUB, 2)
    v = valid.reshape(nchunks * _NSUB, _P // _NSUB, 1)
    lo = torch.where(v, sub, BIG).amin(dim=1) - radius       # [nc*NSUB, 2]
    hi = torch.where(v, sub, -BIG).amax(dim=1) + radius
    hit = ((bbox[None, :, 0] <= hi[:, 0:1]) & (bbox[None, :, 2] >= lo[:, 0:1])
           & (bbox[None, :, 1] <= hi[:, 1:2]) & (bbox[None, :, 3] >= lo[:, 1:2]))
    hit = hit.reshape(nchunks, _NSUB, -1).any(dim=1)         # [nchunks, nblocks]
    nblocks = hit.shape[1]
    ar = torch.arange(nblocks, dtype=torch.int32, device=pts.device)[None, :]
    key = torch.where(hit, ar, nblocks + ar)                 # hits sort first
    order = torch.sort(key, dim=1).values
    ids = torch.where(order < nblocks, order, 0).to(torch.int32).contiguous()
    return ids, hit.sum(dim=1, dtype=torch.int32).contiguous()


def sweep_topk(pts: torch.Tensor, ids: torch.Tensor, nhits: torch.Tensor,
               pack: torch.Tensor, sub: "torch.Tensor | None",
               radius: float, k: int):
    """Wrapper of the CUDA sweep (kernels/sweep.cu): one 256-thread block
    per chunk of ``pts`` walks its own ``nhits`` blocks of ``ids``.
    ``sub`` given = the two-level arm (per-slice culling), None = the
    whole-block arm. → (edge i32, offset f32, dist f32), each [npad, k].
    Raises on anything the kernel does not take, or if the launch fails."""
    from reporter_tpu_torch.kernels.build import launch_sweep

    npad = pts.shape[0]
    nchunks = npad // _P
    if k != SWEEP_K:
        raise ValueError(f"the CUDA sweep is built for K={SWEEP_K}, got {k}")
    if npad % _P or npad == 0:
        raise ValueError(f"points must be whole {_P}-point chunks, got {npad}")
    spad = pack.shape[1]
    nblocks = spad // _SBLK
    checks = [(pts, torch.float32, (npad, 2)),
              (ids, torch.int32, (nchunks, nblocks)),
              (nhits, torch.int32, (nchunks,)),
              (pack, torch.float32, (SP_NCOMP, spad))]
    if sub is not None:
        checks.append((sub, torch.float32, (nblocks, (_SBLK // _SUB) * 4)))
    for t, dtype, shape in checks:
        if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"sweep_topk: expected a contiguous CUDA {dtype} tensor of "
                f"shape {shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if spad % _SBLK:
        raise ValueError(f"pack width {spad} is not a multiple of {_SBLK}")
    edge = torch.empty((npad, k), dtype=torch.int32, device=pts.device)
    off = torch.empty((npad, k), dtype=torch.float32, device=pts.device)
    dist = torch.empty((npad, k), dtype=torch.float32, device=pts.device)
    rc = cull_radius(radius)
    launch_sweep(pts, ids, nhits, pack, sub, nchunks, nblocks, spad,
                 float(radius) * float(radius), rc * rc, edge, off, dist)
    SWEEP_LAUNCHES["sub" if sub is not None else "block"] += 1
    return edge, off, dist


def find_candidates_dense(points: torch.Tensor, seg_pack, radius: float,
                          max_candidates: int, valid=None,
                          subcull: bool = True) -> CandidateSet:
    """points f32 [N, 2] → CandidateSet with [N, K] fields.

    seg_pack: (pack, bbox, sub) tensors on the points' device. ``valid``
    (bool [N]) marks real points; the others still get (ignored) rows but
    take no part in the culling. On a CUDA tensor this launches the sweep
    kernel (two-level arm with ``subcull``, else the whole-block arm); on
    a CPU tensor it runs the plain version. Both give the same candidates
    on every valid point."""
    pack, bbox, sub = seg_pack[0], seg_pack[1], seg_pack[2]
    if points.is_cuda:
        n = points.shape[0]
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=points.device)
        nchunks = max(1, -(-n // _P))
        pts, val = _fill_invalid(points, valid, nchunks)
        ids, nhits = _chunk_block_ids(pts, val, bbox, radius, nchunks)
        edge, off, dist = sweep_topk(pts, ids, nhits, pack.contiguous(),
                                     sub.contiguous() if subcull else None,
                                     radius, max_candidates)
        edge, off, dist = edge[:n], off[:n], dist[:n]
    elif points.device.type == "cpu":
        edge, off, dist = _dense_plain(points, pack, radius, max_candidates)
    else:
        raise ValueError(f"unsupported device {points.device}")
    return CandidateSet(edge=edge, offset=off, dist=dist, valid=edge >= 0)
