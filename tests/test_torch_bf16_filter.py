"""The host side of the bf16 filter arm (kernels/sweep_exact.cu, arm
sub_bf16), on the CPU: its column-side table (seg_coarse's CO_FLT words),
the padding point the kernel puts in for padding columns, and a model of
its paired chain with the clamp shortcut and the early exit.

Tolerance 0 throughout: the table holds the plain version's bf16
intermediates (_bf16_coarse_d2), rounded once on the host, so it must
equal them bit for bit; the model must rebuild the plain d2c of every
pair from the table, and its early exit must decide as the plain gate
(_coarse_bf16_gate) does.
"""

import numpy as np
import pytest
import torch

from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.compiler import compile_network
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RADIUS = 50.0
BF = torch.bfloat16


def _streets(n: int):
    """Parallel streets 500 m apart, 8 m segments every 10 m, the first
    ``n`` of them."""
    x = np.arange(0.0, 4000.0, 10.0)
    y = np.arange(0.0, 4000.0, 500.0)
    a = np.stack(np.meshgrid(x, y), -1).reshape(-1, 2).astype(np.float32)[:n]
    b = (a + np.float32([8.0, 0.0])).astype(np.float32)
    return dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                             np.zeros(n, np.float32),
                             np.full(n, 8.0, np.float32))


@pytest.fixture(scope="module")
def sf():
    """The sf tile's pack (its last real slice holds 118 real columns) and
    2048 fleet points (8 chunks)."""
    ts = compile_network(generate_city("sf"))
    sp = dc.build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                           ts.seg_len)
    pts = np.concatenate([p.xy for p in synthesize_fleet(
        ts, 16, num_points=128, seed=2)]).astype(np.float32)
    return sp, pts


@pytest.fixture(scope="module")
def rows():
    """All 3200 street segments (25 whole slices; the last block's other
    slices are all padding) and 64 patches of 32 points within 30 m of a
    centre, where the bf16 gate culls some voted slices."""
    sp = _streets(3200)
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.0, 4000.0, (64, 1, 2))
    pts = (centres + rng.uniform(-30.0, 30.0, (64, 32, 2))).reshape(-1, 2)
    return sp, pts.astype(np.float32)


@pytest.fixture(scope="module")
def padded():
    """3150 street segments, so slice 24 holds 78 real and 50 padding
    columns, and 512 points over that slice's box and 45 m around it."""
    sp = _streets(3150)
    quad = sp.sub.reshape(-1, 4)[3150 // dc._SUB]
    rng = np.random.default_rng(5)
    pts = rng.uniform(quad[:2] - 45.0, quad[2:] + 45.0, (512, 2))
    return sp, pts.astype(np.float32)


def _degenerate():
    """Segments at the denominator's floor (zero length, and a squared
    length that rounds below bf16(1e-12)) beside ordinary ones."""
    rng = np.random.default_rng(23)
    a = rng.uniform(-2000.0, 2000.0, (300, 2)).astype(np.float32)
    step = np.zeros((300, 2), np.float32)
    step[100:200, 0] = np.float32(3e-7)
    step[200:] = rng.uniform(-80.0, 80.0, (100, 2))
    b = (a + step).astype(np.float32)
    return dc.build_seg_pack(a, b, np.arange(300, dtype=np.int32),
                             np.zeros(300, np.float32),
                             np.linalg.norm(step, axis=1).astype(np.float32))


def _pack(request, tile):
    return _degenerate() if tile == "degenerate" \
        else request.getfixturevalue(tile)[0]


def _table(sp):
    """seg_coarse's filter words decoded → (fields u16 [5, S] in FL_*
    order, column by column; real column count per slice [nslices])."""
    nblocks = sp.coarse.shape[0]
    head = sp.coarse[:, dc.CO_FLT:dc.CO_FLT_COLS].reshape(-1)
    words = np.ascontiguousarray(sp.coarse[:, dc.CO_FLT_COLS:]).view(
        np.uint32).reshape(nblocks, dc.FL_NCOMP, dc._SBLK // 2)
    lo = (words & np.uint32(0xFFFF)).astype(np.uint16)
    hi = (words >> np.uint32(16)).astype(np.uint16)
    cols = np.stack([lo, hi], -1).reshape(nblocks, dc.FL_NCOMP, dc._SBLK)
    return cols.transpose(1, 0, 2).reshape(dc.FL_NCOMP, -1), head


def _plain_column_side(sp, radius: float):
    """The column side of every slice with a real column, op for op as
    _bf16_coarse_d2 computes it (endpoints recentred, clamped into the
    dilated box, then bf16) → (fields bf16 [5, n, 128] in FL_* order,
    slice indices [n], the unclamped recentred endpoints f32 [4, n, 128]
    and the half extents (ex, ey) [2, n, 1])."""
    quads = torch.from_numpy(sp.sub.reshape(-1, 4))
    sl = torch.nonzero(~torch.isnan(quads[:, 0]))[:, 0]
    seg = torch.from_numpy(sp.pack).reshape(dc.SP_NCOMP, -1, dc._SUB)[:, sl]
    lox, loy, hix, hiy, ex, ey = dc._clip_half_box(quads[sl], radius)
    cx = (lox + hix) * 0.5
    cy = (loy + hiy) * 0.5
    raw = [seg[dc.SP_AX] - cx[:, 0], seg[dc.SP_AY] - cy[:, 0],
           seg[dc.SP_BX] - cx[:, 0], seg[dc.SP_BY] - cy[:, 0]]
    e = (ex[:, 0], ey[:, 0], ex[:, 0], ey[:, 0])
    axl, ayl, bxl, byl = (torch.clamp(v, -w, w).to(BF) for v, w in zip(raw, e))
    abx = bxl - axl
    aby = byl - ayl
    den = torch.maximum(abx * abx + aby * aby, torch.tensor(1e-12, dtype=BF))
    return (torch.stack([axl, ayl, abx, aby, den]), sl.numpy(),
            torch.stack(raw), torch.stack([ex[:, 0], ey[:, 0]]))


def _u16(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("tile", ["sf", "rows", "padded", "degenerate"])
def test_filter_table_equals_plain_intermediates(request, tile):
    """Every real column's (axl, ayl, abx, aby, den) in seg_coarse equals
    _bf16_coarse_d2's bf16 intermediates bit for bit, at several radii
    (the clamp leaves real endpoints alone); every padding column holds
    (0, 0, 0, 0, bf16(1e-12)); the head counts each slice's real
    columns."""
    sp = _pack(request, tile)
    assert sp.coarse.shape == (sp.pack.shape[1] // dc._SBLK, dc.CO_WORDS)
    assert sp.coarse.dtype == np.int32 and sp.coarse.flags.c_contiguous
    fields, nreal = _table(sp)
    real = sp.pack[dc.SP_EDGE].view(np.int32) >= 0
    s = int(real.sum())
    np.testing.assert_array_equal(
        nreal, np.clip(s - np.arange(len(nreal)) * dc._SUB, 0, dc._SUB))
    for radius in (0.0, RADIUS, 300.0):
        want, sl, _, _ = _plain_column_side(sp, radius)
        got = fields.reshape(dc.FL_NCOMP, -1, dc._SUB)[:, sl]
        keep = real.reshape(-1, dc._SUB)[sl]
        np.testing.assert_array_equal(got[:, keep], _u16(want)[:, keep])
    eps = _u16(torch.tensor(1e-12, dtype=BF))
    np.testing.assert_array_equal(fields[:4, ~real], 0)
    np.testing.assert_array_equal(fields[dc.FL_DEN, ~real], eps)
    if tile == "degenerate":          # floored denominators
        assert (fields[dc.FL_DEN, real] == eps).sum() >= 100


@pytest.mark.parametrize("tile", ["sf", "rows", "padded", "degenerate"])
def test_clamp_idle_on_real_columns_at_radius_zero(request, tile):
    """At radius 0 (the smallest dilation, 0.5 m) every real column's
    recentred endpoints lie within the half extents, so the plain
    version's clamp leaves them as they are."""
    sp = _pack(request, tile)
    _, sl, raw, e = _plain_column_side(sp, 0.0)
    real = torch.from_numpy(
        sp.pack[dc.SP_EDGE].view(np.int32) >= 0).reshape(-1, dc._SUB)[sl]
    half = torch.cat([e, e])                             # ex ey ex ey
    assert ((raw.abs() <= half) | ~real).all()


def test_build_refuses_a_box_the_clamp_would_cut():
    """Coordinates so large that f32 rounding moves the slice centre by
    more than the 0.5 m dilation: build_seg_pack raises rather than store
    a column side the plain version would clamp."""
    a = np.float32([[1e8, 0.0]])
    b = np.float32([[1e8 + 8.0, 0.0]])
    with pytest.raises(ValueError, match="clamp"):
        dc.build_seg_pack(a, b, np.zeros(1, np.int32), np.zeros(1, np.float32),
                          np.full(1, 8.0, np.float32))


def _padding_point(quad: torch.Tensor, radius: float) -> np.ndarray:
    """The kernel's padding endpoint of a slice: bf16 of the f32 clamp of
    0 - centre into the dilated half extents → u16 [n, 2]."""
    lox, loy, hix, hiy, ex, ey = (v[:, 0, 0] for v in
                                  dc._clip_half_box(quad, radius))
    zero = torch.zeros_like(lox)
    px = torch.clamp(zero - (lox + hix) * 0.5, -ex, ex)
    py = torch.clamp(zero - (loy + hiy) * 0.5, -ey, ey)
    return _u16(torch.stack([px, py], 1).to(BF))


@pytest.mark.parametrize("tile", ["sf", "padded"])
def test_padding_point_equals_clamped_zero_endpoints(request, tile):
    """In the slice that is partly real, the plain version's padding
    columns hold the clamp of zero endpoints (axl, ayl = P; abx = aby =
    0; den = bf16(1e-12)), and P is the point the kernel computes, at
    each radius; P moves with the radius, so no radius-free table could
    hold it."""
    sp = _pack(request, tile)
    real = sp.pack[dc.SP_EDGE].view(np.int32) >= 0
    part = int(real.sum()) // dc._SUB
    assert 0 < int(real[part * dc._SUB:(part + 1) * dc._SUB].sum()) < dc._SUB
    pads = ~real[part * dc._SUB:(part + 1) * dc._SUB]
    quad = torch.from_numpy(sp.sub.reshape(-1, 4)[part:part + 1])
    seen = set()
    for radius in (0.0, 10.0, RADIUS, 300.0):
        want, sl, _, _ = _plain_column_side(sp, radius)
        w = _u16(want)[:, list(sl).index(part)][:, pads]        # [5, npad]
        p = _padding_point(quad, radius)[0]
        np.testing.assert_array_equal(w[dc.FL_AX], p[0])
        np.testing.assert_array_equal(w[dc.FL_AY], p[1])
        np.testing.assert_array_equal(w[dc.FL_ABX:dc.FL_DEN], 0)
        np.testing.assert_array_equal(w[dc.FL_DEN],
                                      _u16(torch.tensor(1e-12, dtype=BF)))
        seen.add(tuple(p))
    assert len(seen) > 1


def _model_d2c(p, quad, words, nreal, radius: float):
    """A model of the kernel's gate chain for n voted tiles: p [n, 32, 2]
    the warp's points, quad [n, 4] the slice box, words [n, 5, 64] the
    slice's pair words (u32; column 2i low half, 2i + 1 high), nreal [n]
    → (d2c f32 [n, 32, 128], threshold f32 [n]). The point side in f32,
    then bf16; the padding columns' endpoint put in from column nreal on;
    t by the clamp shortcut, dividing only where 0 < num < den."""
    lox, loy, hix, hiy, ex, ey = dc._clip_half_box(quad, radius)
    cx = (lox + hix) * 0.5
    cy = (loy + hiy) * 0.5
    pxl = torch.clamp(p[..., 0:1] - cx, -ex, ex).to(BF)          # [n, 32, 1]
    pyl = torch.clamp(p[..., 1:2] - cy, -ey, ey).to(BF)
    lo = (words & np.uint32(0xFFFF)).astype(np.uint16)
    hi = (words >> np.uint32(16)).astype(np.uint16)
    cols = np.stack([lo, hi], -1).reshape(len(words), dc.FL_NCOMP, dc._SUB)
    pad = _padding_point(quad, radius)                            # [n, 2]
    padding = np.arange(dc._SUB)[None, :] >= nreal[:, None]       # [n, 128]
    cols[:, dc.FL_AX] = np.where(padding, pad[:, 0:1], cols[:, dc.FL_AX])
    cols[:, dc.FL_AY] = np.where(padding, pad[:, 1:2], cols[:, dc.FL_AY])
    f = torch.from_numpy(cols.view(np.int16)).view(BF)[:, :, None, :]
    ax, ay, abx, aby, den = (f[:, i] for i in range(dc.FL_NCOMP))
    num = (pxl - ax) * abx + (pyl - ay) * aby                     # [n, 32, 128]
    zero, one = torch.zeros_like(num), torch.ones_like(num)
    t = torch.where(num <= 0, zero, torch.where(
        num >= den, one, torch.clamp(num / den, 0.0, 1.0)))
    dx = pxl - (ax + t * abx)
    dy = pyl - (ay + t * aby)
    scale = torch.maximum(ex, ey)[:, 0, 0]
    rl = (torch.tensor(radius, dtype=torch.float32) + scale * 0.0625 + 0.5)
    return (dx * dx + dy * dy).float(), rl * rl


def _voted_tiles(sp, pts):
    """The plain vote's (warp, slice) tiles: points [n, 32, 2], pack
    columns [n, 8, 128], quads [n, 4], each tile's pair words [n, 5, 64]
    and real column count [n], its (chunk, warp, slot, slice), and the
    plain gate log."""
    pts = torch.from_numpy(pts)
    nchunks = -(-len(pts) // dc._P)
    pack, bbox, sub = (torch.from_numpy(x) for x in sp[:3])
    fpts, fval = dc._fill_invalid(pts, torch.ones(len(pts), dtype=torch.bool),
                                  nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, bbox, RADIUS, nchunks)
    vote = dc._slice_votes(fpts, ids, nhits, sub,
                           dc.cull_radius(RADIUS) ** 2)
    p, seg, (c, w, j, s) = dc._coarse_rows(fpts, ids, vote, pack)
    blk = ids[c, j].long()
    quad = sub[blk].reshape(-1, sub.shape[1] // 4, 4)[torch.arange(len(s)), s]
    half = dc._SUB // 2
    words = np.ascontiguousarray(sp.coarse[:, dc.CO_FLT_COLS:]).view(
        np.uint32).reshape(-1, dc.FL_NCOMP, dc._SBLK // 2)[blk.numpy()]
    words = np.stack([words[i, :, k * half:(k + 1) * half]
                      for i, k in enumerate(s.numpy())])
    nreal = sp.coarse[blk.numpy(), dc.CO_FLT + s.numpy()]
    plain = dc._coarse_bf16_gate(fpts, ids, nhits, pack, sub, RADIUS)
    assert len(s) > 20
    return p, seg, quad, words, nreal, (c, w, j, s), plain


@pytest.mark.parametrize("tile", ["sf", "rows", "padded"])
def test_paired_chain_model_gives_plain_gate(request, tile):
    """From the table, with the padding point put in, the clamp shortcut
    and an early exit after every group of 8, 16, 32 or 64 columns, the
    model rebuilds _bf16_coarse_d2's d2c and threshold of every voted
    tile bit for bit and decides as _coarse_bf16_gate does."""
    sp, pts = request.getfixturevalue(tile)
    p, seg, quad, words, nreal, (c, w, j, s), plain = _voted_tiles(sp, pts)
    d2, thr = _model_d2c(p, quad, words, nreal, RADIUS)
    want, want_thr = dc._bf16_coarse_d2(p, seg, quad, RADIUS)
    np.testing.assert_array_equal(d2.view(torch.int32).numpy(),
                                  want.view(torch.int32).numpy())
    np.testing.assert_array_equal(thr.view(torch.int32).numpy(),
                                  want_thr.view(torch.int32).numpy())
    for group in (8, 16, 32, 64):
        passed = torch.zeros(len(s), dtype=torch.bool)
        for g0 in range(0, dc._SUB, group):
            passed |= (d2[:, :, g0:g0 + group]
                       <= thr[:, None, None]).flatten(1).any(1)
        np.testing.assert_array_equal(passed.numpy(),
                                      plain.gate[c, w, j, s].numpy())
    if tile == "padded":      # voted tiles of the partly real slice
        assert (nreal < dc._SUB).any()
    if tile == "rows":
        assert not passed.all()
