"""Dense candidate search: the segment sweep, as a CUDA kernel on the card
and as plain PyTorch on the CPU.

Counterpart: reporter_tpu/ops/dense_candidates.py. For every probe point
the top-K *distinct* edges within ``radius``, each edge represented by its
closest projection: ordered by (d², edge id), ties broken toward the
smallest edge id, the offset being that edge's smallest tied projection.

- ``build_seg_pack`` Morton-sorts the line segments into 512-column blocks
  of [8, S_pad] f32 component rows (edge ids bit-cast into row 6) with
  per-block and per-128-column-slice bboxes and the per-column feature
  rows of the tensor-core coarse pass — byte-equal to the JAX package's
  pack — and the port's own tables: ``sweep``, the column side of the
  exact geometry, [S_pad, 8] column by column (SW_*), and ``coarse``, the
  gates' operands rounded once: the feature rows in the tensor-core
  gate's operand types, laid out as its fragments, and the bf16 filter's
  column side (CO_*).
- ``_dense_plain`` is the full sweep without culling (the JAX package's
  ``_dense_jnp``), chunked over 128 points. The CPU path and the tests use
  it; ``chip_smoke.py`` holds the kernel against it on the card.
- ``find_candidates_dense`` on a CUDA tensor runs the cull pre-pass
  (``_chunk_block_ids``, plain PyTorch) and then ``sweep_topk``, the
  wrapper of the hand-written kernel ``kernels/sweep_exact.cu``, in one
  of its five arms (``SWEEP_ARMS``), each an instance of one ring-fed
  kernel template. All five return the same candidates.
- ``_coarse_bf16_gate`` and ``_coarse_mxu_gate`` are the plain versions of
  the two coarse arms' gate: per 32-point warp and hit 128-column slice,
  whether the exact pass runs. The card holds the kernel's decisions
  against them; the CPU tests fuzz them for conservativeness.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reporter_tpu_torch.kernels import build
from reporter_tpu_torch.kernels.build import SWEEP_KS

BIG = 1e30

# seg_pack component rows
SP_AX, SP_AY, SP_BX, SP_BY, SP_OFF, SP_LEN, SP_EDGE, SP_SPARE = range(8)
SP_NCOMP = 8

# seg_feat component rows: per-column coefficients such that, for a point
# recentred on its column's slice centre (q = p - c),
#   A·qx² + B·qy² + C·qx·qy + D·qx + E·qy + F
# is the squared distance from p to the segment's infinite line, a lower
# bound on the point-to-segment distance. Rows CX/CY carry that centre.
# Padding columns carry zero coefficients and F = BIG.
SF_A, SF_B, SF_C, SF_D, SF_E, SF_F, SF_CX, SF_CY = range(8)
SF_NCOMP = 8

# seg_sweep fields, per column: the column side of _block_geometry (its
# f32 intermediates) and the edge id's bits, so the exact arms' pairs do
# only the point side. Column-major: a 512-column block is 16 KB in one
# piece; what every pair reads (ax..den, edge) comes first, the offset
# fields that only an in-radius pair reads last.
SW_AX, SW_AY, SW_ABX, SW_ABY, SW_DEN, SW_EDGE, SW_OFF, SW_LEN = range(8)
SW_NCOMP = 8

# Margin of the tensor-core coarse test, relative to the squared clamp-box
# scale, plus an absolute slack (m²): it assumes bf16-grade operand
# rounding for both operand types (the JAX package's argument, kept).
_MXU_REL_MARGIN = 0.0625
_MXU_ABS_MARGIN = 0.5

_P = 256          # points per chunk: one CUDA thread block, one thread a point
_WARP = 32        # points per warp: the unit of the in-kernel slice gates
_SBLK = 512       # segment columns per block (the culling unit)
_SUB = 128        # columns per slice of the kernel's second culling level
_NSUB = 8         # sub-bboxes per chunk in the pre-pass (32 points each)
_PLAIN_P = 128    # points per chunk of the plain sweep (bounds its [P, S] temporaries)
_GATE_ROWS = 2048  # (warp, slice) pairs per step of the plain gates
SPLIT_LEN = 256.0  # long-segment pre-split span
# SWEEP_KS (kernels/build.py): the top-K widths the CUDA sweep is built
# for, each arm instantiated at each; the plain path takes any K

# seg_coarse: the gates' operands, one row of CO_WORDS i32 words per
# 512-column block, rounded once on the host. For the tensor-core gate,
# seg_feat's eight rows per column in each arm's operand type, laid out
# so a lane's B fragment of an m16n8k8 is one shared load, and the slice
# centres; for the bf16 filter, its column side.
#   [CO_TF32, CO_CTR)  tf32 (f32 bits rounded as cvt.rna.tf32 does: to
#                      nearest, ties away from zero), column c at words
#                      8c..8c+7 in k order _CO_TF32_K: lane t reads k = t,
#                      t + 4 as one 8-byte pair;
#   [CO_CTR, CO_BF16)  per slice (cx, cy) f32: rows SF_CX/SF_CY at the
#                      slice's first column;
#   [CO_BF16, CO_FLT)  bf16 (round to nearest even), column c at words
#                      CO_BF16 + 4c + t, each k = 2t in the low half and
#                      2t + 1 in the high half;
#   [CO_FLT, CO_FLT_COLS) per slice its number of real columns (i32);
#   [CO_FLT_COLS, CO_WORDS) the bf16 filter's column side (FL_* fields,
#                      _filter_table): field f of columns 2p, 2p + 1 (low,
#                      high half) at word CO_FLT_COLS + f * 256 + p.
# The mxu arm stages words [CO_TF32, CO_BF16), mxu_bf16 [CO_CTR, CO_FLT),
# sub_bf16 [CO_FLT, CO_WORDS): one contiguous copy each
# (kernels/sweep_exact.cu).
CO_TF32 = 0
CO_CTR = CO_TF32 + SF_NCOMP * _SBLK
CO_BF16 = CO_CTR + 2 * (_SBLK // _SUB)
CO_FLT = CO_BF16 + SF_NCOMP // 2 * _SBLK
CO_FLT_COLS = CO_FLT + _SBLK // _SUB
FL_AX, FL_AY, FL_ABX, FL_ABY, FL_DEN = range(5)
FL_NCOMP = 5
CO_WORDS = CO_FLT_COLS + FL_NCOMP * _SBLK // 2
_CO_TF32_K = (0, 4, 1, 5, 2, 6, 3, 7)

# The sweep's arms: the whole-block arm, the exact two-level arm, the bf16
# coarse filter and the tensor-core coarse pass with tf32 or bf16
# operands, each an instance of kernels/sweep_exact.cu whose launch code
# is its index here.
SWEEP_ARMS = ("block", "sub", "sub_bf16", "mxu", "mxu_bf16")

# Launches of the CUDA sweep, per kernel instance (arm, K). sweep_topk adds
# one per kernel launch and nothing else does; chip_smoke.py resets and
# reads them around each main-path run.
SWEEP_LAUNCHES = {(arm, k): 0 for arm in SWEEP_ARMS for k in SWEEP_KS}


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
    feat: np.ndarray   # f32 [8, S_pad] per-column coarse-pass rows (SF_*)
    sweep: np.ndarray  # f32 [S_pad, 8] per-column exact-sweep fields (SW_*)
    coarse: np.ndarray  # i32 [nblocks, CO_WORDS] the gate's operands (CO_*)


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
    quads = quads.astype(np.float32)
    sub = quads.reshape(nblocks, nsub * 4)

    # coarse-pass rows: coefficients in f64, stored in f32; the slice
    # centre rides rows CX/CY so the kernel never recomputes it
    centers = np.stack([(quads[:, 0] + quads[:, 2]) * np.float32(0.5),
                        (quads[:, 1] + quads[:, 3]) * np.float32(0.5)], axis=1)
    c64 = np.repeat(centers, subw, axis=0).astype(np.float64)   # [spad, 2]
    a64 = np.stack([pack[SP_AX], pack[SP_AY]], 1).astype(np.float64)
    b64 = np.stack([pack[SP_BX], pack[SP_BY]], 1).astype(np.float64)
    d64 = b64 - a64
    w = 1.0 / np.maximum((d64 * d64).sum(1), 1e-12)
    e64 = a64 - c64
    g = e64[:, 0] * d64[:, 1] - e64[:, 1] * d64[:, 0]           # e × d
    feat = np.zeros((SF_NCOMP, spad), np.float32)
    feat[SF_A] = np.where(real, d64[:, 1] ** 2 * w, 0.0)
    feat[SF_B] = np.where(real, d64[:, 0] ** 2 * w, 0.0)
    feat[SF_C] = np.where(real, -2.0 * d64[:, 0] * d64[:, 1] * w, 0.0)
    feat[SF_D] = np.where(real, -2.0 * g * d64[:, 1] * w, 0.0)
    feat[SF_E] = np.where(real, 2.0 * g * d64[:, 0] * w, 0.0)
    feat[SF_F] = np.where(real, g * g * w, BIG)
    feat[SF_CX] = c64[:, 0]
    feat[SF_CY] = c64[:, 1]
    return SegPack(pack=pack, bbox=bbox, sub=sub, feat=feat,
                   sweep=_sweep_table(pack),
                   coarse=np.ascontiguousarray(np.concatenate(
                       [_coarse_table(feat, centers, nblocks),
                        _filter_table(pack, quads, s, nblocks)], axis=1)))


def _sweep_table(pack: np.ndarray) -> np.ndarray:
    """seg_sweep [S_pad, 8] from the pack's rows: numpy f32 arithmetic,
    one rounding per operation in _column_side's order, so every field
    equals the plain version's intermediate bit for bit."""
    ax, ay = pack[SP_AX], pack[SP_AY]
    abx = pack[SP_BX] - ax
    aby = pack[SP_BY] - ay
    den = np.maximum(abx * abx + aby * aby, np.float32(1e-12))
    return np.ascontiguousarray(np.stack(
        [ax, ay, abx, aby, den, pack[SP_EDGE], pack[SP_OFF], pack[SP_LEN]],
        axis=1), dtype=np.float32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → the bits (u16) of its bf16 rounding to nearest even, as
    __float2bfloat16_rn and torch's cast give for every non-NaN value."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
            >> np.uint32(16)).astype(np.uint16)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (u16) → their value as f32 (exact)."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _coarse_table(feat: np.ndarray, centers: np.ndarray,
                  nblocks: int) -> np.ndarray:
    """seg_coarse's words [CO_TF32, CO_FLT) per block ([nblocks, words]
    i32) from the feat rows and the slice centres ([nslices, 2] f32): the
    tf32 words equal _tf32_rna(feat) and the bf16 halves
    feat.to(torch.bfloat16), bit for bit (a NaN, in the centre rows of an
    all-padding slice, becomes the canonical 0x7fc0)."""
    bits = np.ascontiguousarray(feat).view(np.int32)             # [8, S]
    tf32 = (bits + np.int32(0x1000)) & np.int32(-0x2000)
    bf16 = _bf16_bits(feat)
    bf16[np.isnan(feat)] = 0x7FC0

    def cols(rows):                      # [k, S] → per block, column-major
        return np.ascontiguousarray(rows.T).reshape(nblocks, -1)

    return np.ascontiguousarray(np.concatenate(
        [cols(tf32[list(_CO_TF32_K)]),
         np.ascontiguousarray(centers, np.float32).reshape(nblocks, -1)
         .view(np.int32),
         cols(bf16).view(np.int32)], axis=1))


def _filter_table(pack: np.ndarray, quads: np.ndarray, s: int,
                  nblocks: int) -> np.ndarray:
    """seg_coarse's words [CO_FLT, CO_WORDS) per block ([nblocks, words]
    i32): the bf16 filter's column side, which the plain version
    (_bf16_coarse_d2) computes per slice and the JAX kernel per grid step
    (:584-597), rounded once here. Per column (FL_*): its endpoints
    recentred on the slice centre, then bf16 (axl, ayl); the bf16
    differences to the far endpoint (abx, aby); den = max(abx² + aby²,
    bf16(1e-12)). Each bf16 operation is done in f32 and rounded to bf16,
    which equals the bf16 operation (f32's 24 significand bits are at
    least 2 * 8 + 2).

    The plain version first clamps every endpoint into the slice's box
    dilated by ~radius. A real column's endpoints lie in the box, so the
    clamp leaves them alone at every radius: checked here at the smallest
    dilation (radius 0, 0.5 m), from which the box only grows. Padding
    columns (zero endpoints) do clamp, to a point that depends on the
    radius: they hold (0, 0, 0, 0, bf16(1e-12)) here, and the kernel puts
    its own clamp of (0, 0) in for the endpoint from column nreal of the
    slice on (the CO_FLT words; abx, aby and den need nothing, since the
    clamped endpoints coincide)."""
    spad = pack.shape[1]
    subw = spad // len(quads)
    real = np.arange(spad) < s
    q = np.repeat(quads, subw, axis=0)                           # [S, 4]
    half = np.float32(0.5)
    with np.errstate(invalid="ignore"):     # NaN quads: all-padding slices
        c = np.stack([(q[:, 0] + q[:, 2]) * half, (q[:, 1] + q[:, 3]) * half])
        e = np.stack([(q[:, 2] - q[:, 0]) * half + half,
                      (q[:, 3] - q[:, 1]) * half + half])

        def recentred(rows):                  # [2, S] f32 → bf16 bits
            d = np.where(real, rows - c, np.float32(0.0))
            if (np.abs(d) > e)[:, real].any():
                raise ValueError("a segment endpoint lies outside its "
                                 "slice's box: the bf16 filter's table "
                                 "needs the clamp to leave it alone")
            return _bf16_bits(d)

        a = recentred(pack[[SP_AX, SP_AY]])
        b = recentred(pack[[SP_BX, SP_BY]])
    ab = _bf16_value(_bf16_bits(_bf16_value(b) - _bf16_value(a)))
    sq = _bf16_value(_bf16_bits(ab * ab))
    den = np.maximum(_bf16_value(_bf16_bits(sq[0] + sq[1])),
                     _bf16_value(_bf16_bits(np.float32(1e-12))))
    fields = np.concatenate([a, _bf16_bits(ab), _bf16_bits(den)[None]])
    pairs = (fields[:, 0::2].astype(np.uint32)
             | (fields[:, 1::2].astype(np.uint32) << np.uint32(16)))
    pairs = pairs.reshape(FL_NCOMP, nblocks, -1).transpose(1, 0, 2)
    nreal = np.clip(s - np.arange(len(quads)) * subw, 0, subw)
    return np.ascontiguousarray(np.concatenate(
        [nreal.reshape(nblocks, -1).astype(np.int32),
         pairs.reshape(nblocks, -1).view(np.int32)], axis=1))


def cull_radius(radius: float) -> float:
    """The slice cull's dilated radius: absorbs f32 rounding of the
    point-to-bbox lower bound, so the cull never drops a pair the exact
    r² test would keep."""
    return float(radius) * 1.0005 + 0.01


def _column_side(seg):
    """The column side of the geometry of a [8, C] segment block, each
    [1, C], in SW_* order: (ax, ay, abx, aby, denom, edge i32, off0, len)
    — the fields of seg_sweep, which the exact kernel arms read instead."""
    ax = seg[SP_AX:SP_AX + 1, :]
    ay = seg[SP_AY:SP_AY + 1, :]
    abx = seg[SP_BX:SP_BX + 1, :] - ax
    aby = seg[SP_BY:SP_BY + 1, :] - ay
    denom = torch.clamp_min(abx * abx + aby * aby, 1e-12)
    return (ax, ay, abx, aby, denom,
            seg[SP_EDGE:SP_EDGE + 1, :].view(torch.int32),
            seg[SP_OFF:SP_OFF + 1, :], seg[SP_LEN:SP_LEN + 1, :])


def _block_geometry(px, py, seg):
    """Distances/offsets of a [P,1] point column against a [8, C] segment
    block → (d2 [P,C], edge [P,C] i32, offabs [P,C]). Every operation is a
    separate rounding in the JAX reference's order (the kernel repeats it
    with contraction off)."""
    ax, ay, abx, aby, denom, edge, off0, slen = _column_side(seg)
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


def _chunk_order(nhits: torch.Tensor) -> torch.Tensor:
    """The order in which the ring-fed kernel's persistent CTAs take
    chunks: a stable permutation of the chunk indices by descending hit
    count (heaviest first, ties in index order) → i32 [nchunks]. The plain
    version of kernels/sweep_exact.cu's chunk_order_kernel."""
    return torch.sort(nhits, descending=True, stable=True).indices.to(
        torch.int32).contiguous()


class GateLog(NamedTuple):
    """Per (chunk, warp, hit slot j, slice) decisions of a coarse arm
    ([nchunks, P/32, nblocks, nsub]; slot j is block ids[chunk, j], slots
    past nhits are False)."""

    vote: torch.Tensor     # bool: a warp point lies within the cull radius
    #                        of the slice's bbox (the two-level arm's test)
    gate: torch.Tensor     # bool: vote, and the coarse test admits the slice
    cmin: "torch.Tensor | None" = None   # f32 the warp's coarse minimum
    thr: "torch.Tensor | None" = None    # f32 the slice's threshold


def _slice_votes(pts, ids, nhits, sub, rc2: float):
    """The kernel's warp vote in plain PyTorch → bool [nc, P/32, nb, nsub]."""
    nchunks, nblocks = ids.shape
    hit = torch.arange(nblocks, device=ids.device)[None, :] < nhits[:, None]
    blk = torch.where(hit, ids, 0).long()
    quads = sub[blk].reshape(nchunks, 1, 1, nblocks, -1, 4)
    p = pts.reshape(nchunks, _P // _WARP, _WARP, 1, 1, 2)
    lo, hi = quads[..., 0:2], quads[..., 2:4]
    d = torch.clamp_min(torch.maximum(lo - p, p - hi), 0.0)
    near = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) <= rc2) \
        & (lo <= hi).all(-1)
    return near.any(2) & hit[:, None, :, None]


def _coarse_rows(pts, ids, vote, table):
    """For each voted (chunk, warp, slot, slice): the warp's points
    [n, 32, 2] and the slice's 128 columns of ``table`` [n, 8, 128]."""
    c, w, j, s = vote.nonzero(as_tuple=True)
    start = (c * _P + w * _WARP)[:, None] + torch.arange(
        _WARP, device=pts.device)
    col0 = ids[c, j].long() * _SBLK + s * _SUB
    cols = col0[:, None] + torch.arange(_SUB, device=pts.device)
    return pts[start], table[:, cols].permute(1, 0, 2), (c, w, j, s)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _clip_half_box(quad, radius: float):
    """The recentring box of a slice: (lox, loy, hix, hiy), each [n, 1, 1],
    and the half extents dilated by ~radius (ex, ey)."""
    lox, loy, hix, hiy = (quad[:, i, None, None] for i in range(4))
    mx = _f32(radius, quad) * _f32(1.001, quad) + _f32(0.5, quad)
    ex = (hix - lox) * 0.5 + mx
    ey = (hiy - loy) * 0.5 + mx
    return lox, loy, hix, hiy, ex, ey


def _bf16_coarse_d2(p, seg, quad, radius: float):
    """The bf16 filter's pair distances: p [n, 32, 2] points, seg [n, 8,
    128] pack columns, quad [n, 4] the slice's bbox → (d²c f32 [n, 32,
    128], threshold f32 [n]). Every operation after the recentre and clamp
    is a bf16 operation, rounded once, in the JAX kernel's order."""
    bf = torch.bfloat16
    lox, loy, hix, hiy, ex, ey = _clip_half_box(quad, radius)
    cx = (lox + hix) * 0.5
    cy = (loy + hiy) * 0.5

    def clip(v, c, e):
        return torch.clamp(v - c, -e, e).to(bf)

    pxl, pyl = clip(p[..., 0:1], cx, ex), clip(p[..., 1:2], cy, ey)
    axl = clip(seg[:, SP_AX:SP_AX + 1], cx, ex)
    ayl = clip(seg[:, SP_AY:SP_AY + 1], cy, ey)
    bxl = clip(seg[:, SP_BX:SP_BX + 1], cx, ex)
    byl = clip(seg[:, SP_BY:SP_BY + 1], cy, ey)
    abx = bxl - axl
    aby = byl - ayl
    den = torch.maximum(abx * abx + aby * aby,
                        torch.tensor(1e-12, dtype=bf, device=p.device))
    t = torch.clamp(((pxl - axl) * abx + (pyl - ayl) * aby) / den, 0.0, 1.0)
    dxl = pxl - (axl + t * abx)
    dyl = pyl - (ayl + t * aby)
    d2c = (dxl * dxl + dyl * dyl).to(torch.float32)
    scale = torch.maximum(ex, ey)[:, 0, 0]
    rl = _f32(radius, p) + scale * _f32(0.0625, p) + _f32(0.5, p)
    return d2c, rl * rl


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 → tf32 (10 mantissa bits), rounded to nearest with ties away
    from zero: what the kernel's cvt.rna.tf32.f32 gives."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _mxu_coarse_d2(p, feat, quad, radius: float, lowp: str):
    """The tensor-core coarse pass's pair values: p [n, 32, 2], feat [n, 8,
    128] coarse rows of the slice, quad [n, 4] → (point-to-line d² f32 [n,
    32, 128], threshold f32 [n]). Features and coefficients are rounded to
    the operand type (bf16, or tf32 for lowp="off"); the product
    accumulates in f32."""
    _, _, _, _, exm, eym = _clip_half_box(quad, radius)
    cx = feat[:, SF_CX, 0, None, None]
    cy = feat[:, SF_CY, 0, None, None]
    qx = torch.clamp(p[..., 0:1] - cx, -exm, exm)
    qy = torch.clamp(p[..., 1:2] - cy, -eym, eym)
    one, zero = torch.ones_like(qx), torch.zeros_like(qx)
    pf = torch.cat([qx * qx, qy * qy, qx * qy, qx, qy, one, zero, zero], -1)
    if lowp == "bf16":
        lhs = pf.to(torch.bfloat16).to(torch.float32)
        rhs = feat.to(torch.bfloat16).to(torch.float32)
    else:
        lhs, rhs = _tf32_rna(pf), _tf32_rna(feat)
    d2m = torch.bmm(lhs, rhs)
    scale = torch.maximum(exm, eym)[:, 0, 0]
    thr = (_f32(radius * radius, p) + scale * scale * _f32(_MXU_REL_MARGIN, p)
           + _f32(_MXU_ABS_MARGIN, p))
    return d2m, thr


def _coarse_gate(pts, ids, nhits, sub, radius: float, table, pairs):
    vote = _slice_votes(pts, ids, nhits, sub, cull_radius(radius) ** 2)
    gp, rows, (c, w, j, s) = _coarse_rows(pts, ids, vote, table)
    quad = sub[ids[c, j].long()].reshape(-1, sub.shape[1] // 4, 4)[
        torch.arange(len(s), device=pts.device), s]
    cmin = torch.full(vote.shape, BIG, dtype=torch.float32, device=pts.device)
    thr = torch.zeros(vote.shape, dtype=torch.float32, device=pts.device)
    mins, thrs = [], []
    for lo in range(0, len(s), _GATE_ROWS):
        d2, th = pairs(gp[lo:lo + _GATE_ROWS], rows[lo:lo + _GATE_ROWS],
                       quad[lo:lo + _GATE_ROWS])
        mins.append(d2.amin(dim=(1, 2)))
        thrs.append(th)
    if mins:
        cmin[c, w, j, s] = torch.cat(mins)
        thr[c, w, j, s] = torch.cat(thrs)
    return GateLog(vote=vote, gate=vote & (cmin <= thr), cmin=cmin, thr=thr)


def _coarse_bf16_gate(pts, ids, nhits, pack, sub, radius: float) -> GateLog:
    """Plain version of the bf16 arm's gate: for every hit slice a warp's
    vote passes, the minimum of the bf16 d²c over its 32 points × the
    slice's 128 columns, against (r + 0.0625·scale + 0.5)². ``pts`` are
    the filled [nchunks·256, 2] points the kernel sweeps."""
    return _coarse_gate(pts, ids, nhits, sub, radius, pack,
                        lambda p, seg, q: _bf16_coarse_d2(p, seg, q, radius))


def _coarse_mxu_gate(pts, ids, nhits, sub, feat, radius: float,
                     lowp: str) -> GateLog:
    """Plain version of the tensor-core arm's gate: the minimum point-to-
    line d² of the warp's 32 points × the slice's 128 columns, against
    r² + scale²·_MXU_REL_MARGIN + _MXU_ABS_MARGIN."""
    return _coarse_gate(pts, ids, nhits, sub, radius, feat,
                        lambda p, f, q: _mxu_coarse_d2(p, f, q, radius, lowp))


def decode_gate_log(log: torch.Tensor, nsub: int = _SBLK // _SUB) -> GateLog:
    """The kernel's debug words (i32 [nchunks, P/32, nblocks]: bit s = the
    vote on slice s, bit nsub + s = its gate) → GateLog."""
    bits = torch.arange(nsub, device=log.device)
    vote = (log[..., None] >> bits) & 1
    gate = (log[..., None] >> (bits + nsub)) & 1
    return GateLog(vote=vote.bool(), gate=gate.bool())


def sweep_arm(subcull: bool, lowp: str, mxu: bool) -> str:
    """The kernel arm that serves these levers (a name of SWEEP_ARMS)."""
    if mxu:
        return "mxu_bf16" if lowp == "bf16" else "mxu"
    if not subcull:
        return "block"
    return "sub_bf16" if lowp == "bf16" else "sub"


def sweep_topk(pts: torch.Tensor, ids: torch.Tensor, nhits: torch.Tensor,
               sweep: torch.Tensor, sub: "torch.Tensor | None",
               coarse: "torch.Tensor | None", radius: float, k: int,
               arm: str, gate_log: "torch.Tensor | None" = None):
    """Wrapper of the CUDA sweep kernel (kernels/sweep_exact.cu) over the
    chunks of ``pts`` and their hit lists (``ids``, ``nhits``), in arm
    ``arm`` of SWEEP_ARMS. Every arm reads the ``sweep`` table (seg_sweep):
    "block" alone, "sub" also ``sub`` (per-slice culling), the gated arms
    ("sub_bf16", "mxu", "mxu_bf16") also ``coarse`` (seg_coarse, their
    gates' operands). Its persistent CTAs take chunks from a counter in
    the order _chunk_order(nhits) gives (heaviest first), which a kernel
    of the same call computes on the card. ``k``, the top-K width, is one
    of SWEEP_KS (any other raises).
    → (edge i32, offset f32, dist f32), each [npad, k].

    ``gate_log`` (zeroed i32 [nchunks, P/32, nblocks]; not for "block"),
    when given, receives each warp's slice decisions (decode_gate_log) for
    a check against the plain vote and gates; the gated arms also set bit
    8 + s where slice s's gate passed in its first group of columns.
    Raises on anything the kernel does not take, or if the launch
    fails."""
    if arm not in SWEEP_ARMS:
        raise ValueError(f"unknown sweep arm {arm!r}; one of {SWEEP_ARMS}")
    npad = pts.shape[0]
    nchunks = npad // _P
    if k not in SWEEP_KS:
        raise ValueError(f"the CUDA sweep is built for K in {SWEEP_KS}, "
                         f"got {k}")
    if npad % _P or npad == 0:
        raise ValueError(f"points must be whole {_P}-point chunks, got {npad}")
    if arm == "block" and gate_log is not None:
        raise ValueError("the block arm sweeps every column: it keeps no "
                         "gate log")
    spad = -1 if sweep is None else sweep.shape[0]
    nblocks = spad // _SBLK
    checks = [(sweep, torch.float32, (spad, SW_NCOMP)),
              (pts, torch.float32, (npad, 2)),
              (ids, torch.int32, (nchunks, nblocks)),
              (nhits, torch.int32, (nchunks,))]
    if arm != "block":
        checks.append((sub, torch.float32, (nblocks, (_SBLK // _SUB) * 4)))
    if arm not in ("block", "sub"):
        checks.append((coarse, torch.int32, (nblocks, CO_WORDS)))
    if gate_log is not None:
        checks.append((gate_log, torch.int32, (nchunks, _P // _WARP, nblocks)))
    for t, dtype, shape in checks:
        if t is None or not t.is_cuda or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            got = "None" if t is None else \
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            raise ValueError(f"sweep_topk ({arm}): expected a contiguous "
                             f"CUDA {dtype} tensor of shape {shape}, got {got}")
    if spad % _SBLK:
        raise ValueError(f"seg_sweep's {spad} columns are not whole "
                         f"{_SBLK}-column blocks")
    edge = torch.empty((npad, k), dtype=torch.int32, device=pts.device)
    off = torch.empty((npad, k), dtype=torch.float32, device=pts.device)
    dist = torch.empty((npad, k), dtype=torch.float32, device=pts.device)
    r2 = float(radius) * float(radius)
    rc = cull_radius(radius)
    order = torch.empty(nchunks + 1, dtype=torch.int32, device=pts.device)
    build.launch_sweep_exact(
        pts, ids, nhits, order, sweep, sub if arm != "block" else None,
        coarse if arm not in ("block", "sub") else None,
        SWEEP_ARMS.index(arm), nchunks, nblocks, r2, rc * rc, float(radius),
        edge, off, dist, gate_log)
    SWEEP_LAUNCHES[arm, k] += 1
    return edge, off, dist


def find_candidates_dense(points: torch.Tensor, seg_pack, radius: float,
                          max_candidates: int, valid=None,
                          subcull: bool = True, lowp: str = "off",
                          mxu: bool = False) -> CandidateSet:
    """points f32 [N, 2] → CandidateSet with [N, K] fields.

    seg_pack: (pack, bbox[, sub[, feat[, sweep[, coarse]]]]) tensors on
    the points' device (a SegPack's fields, in order); without ``sub`` the
    whole-block arm runs, and on a CUDA tensor every arm needs ``sweep``
    and the gated arms (the bf16 filter, the tensor-core pass) ``coarse``.
    ``valid`` (bool [N]) marks real points; the others still get (ignored)
    rows but take no part in the culling. ``lowp="bf16"`` adds the bf16
    coarse filter to the two-level arm; ``mxu`` the tensor-core coarse
    pass (needs ``feat``), whose operands ``lowp`` then picks. On a CUDA
    tensor this launches the sweep kernel in that arm; on a CPU tensor it
    runs the plain version.
    Every arm gives the same candidates on every valid point; the illegal
    combinations raise as the JAX package's do."""
    pack, bbox = seg_pack[0], seg_pack[1]
    sub = seg_pack[2] if len(seg_pack) > 2 else None
    feat = seg_pack[3] if len(seg_pack) > 3 else None
    sweep = seg_pack[4] if len(seg_pack) > 4 else None
    coarse = seg_pack[5] if len(seg_pack) > 5 else None
    use_sub = bool(subcull) and sub is not None
    if lowp not in ("off", "bf16"):
        raise ValueError(f"unknown lowp {lowp!r}; use 'off' or 'bf16'")
    if lowp == "bf16" and not use_sub and not mxu:
        raise ValueError(
            "lowp='bf16' requires the two-level kernel: subcull=True and "
            "a seg_pack built with sub quads")
    if mxu and (not use_sub or feat is None):
        raise ValueError(
            "mxu=True requires the two-level kernel (subcull=True) and a "
            "seg_pack built with feat rows")
    if points.is_cuda:
        n = points.shape[0]
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=points.device)
        nchunks = max(1, -(-n // _P))
        pts, val = _fill_invalid(points, valid, nchunks)
        ids, nhits = _chunk_block_ids(pts, val, bbox, radius, nchunks)
        arm = sweep_arm(use_sub, lowp, mxu)
        edge, off, dist = sweep_topk(
            pts, ids, nhits, None if sweep is None else sweep.contiguous(),
            sub.contiguous() if use_sub else None,
            None if coarse is None else coarse.contiguous(),
            radius, max_candidates, arm)
        edge, off, dist = edge[:n], off[:n], dist[:n]
    elif points.device.type == "cpu":
        edge, off, dist = _dense_plain(points, pack, radius, max_candidates)
    else:
        raise ValueError(f"unsupported device {points.device}")
    return CandidateSet(edge=edge, offset=off, dist=dist, valid=edge >= 0)
