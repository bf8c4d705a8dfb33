"""The host side of the tensor-core gate (kernels/sweep_exact.cu, arms mxu
and mxu_bf16), on the CPU: its seg_coarse operand table, a model of its
per-lane fragment indexing, and its early exit.

Tolerance 0 throughout. The table holds seg_feat's rows rounded once, so
it must equal the plain version's rounding (_tf32_rna, torch's bf16
cast) bit for bit; the fragment model must rebuild exactly the plain
version's operands, so its products are the plain products; the early
exit must decide as the plain minimum does over the same products. Only
a NaN, in the centre rows of an all-padding slice, which no vote ever
admits, is compared as NaN rather than by its bits.
"""

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.compiler import compile_network

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RADIUS = 50.0
GROUP = 4          # n-tiles per __any_sync of the kernel's gate (kGroup)


@pytest.fixture(scope="module")
def sf():
    """The sf tile's pack and 2048 fleet points (8 chunks)."""
    ts = compile_network(generate_city("sf"))
    sp = dc.build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                           ts.seg_len)
    pts = np.concatenate([p.xy for p in synthesize_fleet(
        ts, 16, num_points=128, seed=2)]).astype(np.float32)
    return sp, pts


@pytest.fixture(scope="module")
def rows():
    """Parallel streets 500 m apart (8 m segments every 10 m; the last
    block has all-padding slices) and 64 patches of 32 points within 30 m
    of a centre, where the point-to-line bound culls some voted slices."""
    x = np.arange(0.0, 4000.0, 10.0)
    y = np.arange(0.0, 4000.0, 500.0)
    a = np.stack(np.meshgrid(x, y), -1).reshape(-1, 2).astype(np.float32)
    b = (a + np.float32([8.0, 0.0])).astype(np.float32)
    n = len(a)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           np.zeros(n, np.float32),
                           np.full(n, 8.0, np.float32))
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.0, 4000.0, (64, 1, 2))
    pts = (centres + rng.uniform(-30.0, 30.0, (64, 32, 2))).reshape(-1, 2)
    return sp, pts.astype(np.float32)


def _same_or_nan(got: np.ndarray, want: np.ndarray, bits: np.ndarray,
                 want_bits: np.ndarray) -> None:
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(bits[~nan], want_bits[~nan])


@pytest.mark.parametrize("tile", ["sf", "rows"])
def test_coarse_table_equals_rounded_feat(request, tile):
    """seg_coarse's tf32 words equal _tf32_rna(feat) and its bf16 halves
    feat.to(torch.bfloat16), re-laid out column by column in the kernel's
    fragment order, padding columns (F = BIG) included."""
    sp, _ = request.getfixturevalue(tile)
    nblocks = sp.pack.shape[1] // dc._SBLK
    assert sp.coarse.dtype == np.int32 and sp.coarse.flags.c_contiguous
    assert sp.coarse.shape == (nblocks, dc.CO_WORDS)
    feat = torch.from_numpy(sp.feat)
    tf = dc._tf32_rna(feat).view(torch.int32).numpy()           # [8, S]
    got = sp.coarse[:, dc.CO_TF32:dc.CO_CTR].reshape(nblocks, dc._SBLK, 8)
    np.testing.assert_array_equal(    # word w of a column holds k = K[w]
        got[:, :, np.argsort(dc._CO_TF32_K)].reshape(-1, 8).T, tf)
    want = feat.to(torch.bfloat16)
    got = np.ascontiguousarray(sp.coarse[:, dc.CO_BF16:dc.CO_FLT]).view(
        np.uint16).reshape(-1, 8).T                              # [8, S]
    got_f = torch.from_numpy(got.astype(np.int32) << 16).view(
        torch.float32).numpy()
    _same_or_nan(got_f, want.float().numpy(), got,
                 want.view(torch.int16).numpy().view(np.uint16))
    padding = sp.pack[dc.SP_EDGE].view(np.int32) < 0
    assert padding.any()
    assert (sp.feat[dc.SF_F][padding] == np.float32(dc.BIG)).all()


@pytest.mark.parametrize("tile", ["sf", "rows"])
def test_coarse_table_centres(request, tile):
    """The staged centres equal the feat rows SF_CX / SF_CY at each slice's
    first column (the JAX kernel reads them there)."""
    sp, _ = request.getfixturevalue(tile)
    nslices = sp.pack.shape[1] // dc._SUB
    got = np.ascontiguousarray(sp.coarse[:, dc.CO_CTR:dc.CO_BF16]).view(
        np.float32).reshape(nslices, 2)
    first = np.arange(nslices) * dc._SUB
    want = sp.feat[[dc.SF_CX, dc.SF_CY]][:, first].T
    _same_or_nan(got, want, got.view(np.int32), want.view(np.int32))
    if tile == "rows":
        assert np.isnan(got).any() and not np.isnan(got).all()


def _gate_tiles(sp, pts):
    """Every voted (chunk, warp, slot, slice) of the plain vote: the warp's
    points [n, 32, 2], the slice's feat rows [n, 8, 128], its quad [n, 4],
    its block [n] and slice index [n]."""
    pts = torch.from_numpy(pts)
    nchunks = len(pts) // dc._P
    pack, bbox, sub, feat = (torch.from_numpy(x) for x in sp[:4])
    valid = torch.ones(len(pts), dtype=torch.bool)
    ids, nhits = dc._chunk_block_ids(pts, valid, bbox, RADIUS, nchunks)
    vote = dc._slice_votes(pts, ids, nhits, sub, dc.cull_radius(RADIUS) ** 2)
    p, frows, (c, w, j, s) = dc._coarse_rows(pts, ids, vote, feat)
    blk = ids[c, j].long()
    quad = sub[blk].reshape(-1, sub.shape[1] // 4, 4)[
        torch.arange(len(s)), s]
    assert len(s) > 20
    return p, frows, quad, blk.numpy(), s.numpy()


def _tf32(x: np.ndarray) -> np.ndarray:
    return ((x.view(np.int32) + np.int32(0x1000)) & np.int32(-0x2000)).view(
        np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float(
    ).numpy()


def _lane_features(t, x, y, bf16):
    """sweep_exact.cu features<BF16>: lane t's two features of (x, y)."""
    one, zero = np.float32(1.0), np.float32(0.0)
    if bf16:
        lo = x * x if t == 0 else x * y if t == 1 else y if t == 2 else zero
        hi = y * y if t == 0 else x if t == 1 else one if t == 2 else zero
        return lo, hi
    u, v = (y if t == 1 else x), (x if t == 0 else y)
    return (x if t == 3 else u * v), (y if t == 0 else one if t == 1
                                      else zero)


def _fragment_operands(p, quad, co_row, sl, bf16):
    """A model of one warp's gate operands as the kernel reads them: per
    lane (g = lane / 4, t = lane % 4) the A registers from the points of
    lanes mt*16 + h*8 + g (its __shfl_sync sources) and the B registers at
    its seg_coarse words; each placed where the PTX ISA's m16n8k8 layout
    puts that register. → (A [32, 8], B [8, 128]) f32."""
    mx = np.float32(RADIUS) * np.float32(1.001) + np.float32(0.5)
    ctr = co_row[dc.CO_CTR:dc.CO_BF16].view(np.float32).reshape(-1, 2)[sl]
    ex = (quad[2] - quad[0]) * np.float32(0.5) + mx
    ey = (quad[3] - quad[1]) * np.float32(0.5) + mx
    qx = np.clip(p[:, 0] - ctr[0], -ex, ex).astype(np.float32)
    qy = np.clip(p[:, 1] - ctr[1], -ey, ey).astype(np.float32)
    A = np.full((32, 8), np.nan, np.float32)
    B = np.full((8, dc._SUB), np.nan, np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for mt in range(2):
            for h in range(2):
                src = mt * 16 + h * 8 + g
                lo, hi = _lane_features(t, qx[src], qy[src], bf16)
                row = mt * 16 + g + 8 * h
                if bf16:                 # a_h: k = 2t (low), 2t + 1 (high)
                    A[row, 2 * t:2 * t + 2] = _bf16(np.float32([lo, hi]))
                else:                    # a_h at k = t, a_{h+2} at k = t + 4
                    A[row, t] = _tf32(np.float32([lo]))[0]
                    A[row, t + 4] = _tf32(np.float32([hi]))[0]
        for nt in range(dc._SUB // 8):
            c = sl * dc._SUB + nt * 8 + g          # the B fragment's column
            n = nt * 8 + g
            if bf16:                     # b0: k = 2t (low), 2t + 1 (high)
                w = co_row[dc.CO_BF16 + 4 * c + t:dc.CO_BF16 + 4 * c + t + 1]
                h16 = w.view(np.uint16).astype(np.int32) << 16
                B[2 * t:2 * t + 2, n] = h16.view(np.float32)
            else:                        # b0 at k = t, b1 at k = t + 4
                b0, b1 = co_row[8 * c + 2 * t:8 * c + 2 * t + 2].view(
                    np.float32)
                B[t, n], B[t + 4, n] = b0, b1
    return A, B


@pytest.mark.parametrize("tile", ["sf", "rows"])
@pytest.mark.parametrize("lowp", ["off", "bf16"])
def test_fragment_model_gives_plain_products(request, tile, lowp):
    """The kernel's per-lane fragment indexing (A from shuffled rows, B
    from seg_coarse) rebuilds exactly _mxu_coarse_d2's rounded operands,
    so the [32, 128] products are its products, for both operand types; a
    wrong k index between A and B would not."""
    sp, pts = request.getfixturevalue(tile)
    p, frows, quad, blk, sl = _gate_tiles(sp, pts)
    pick = np.linspace(0, len(sl) - 1, 24).astype(int)
    p, frows, quad, blk, sl = p[pick], frows[pick], quad[pick], blk[pick], \
        sl[pick]
    bf16 = lowp == "bf16"
    A, B = zip(*(_fragment_operands(p[i].numpy(), quad[i].numpy(),
                                    sp.coarse[blk[i]], sl[i], bf16)
                 for i in range(len(sl))))
    A, B = torch.from_numpy(np.stack(A)), torch.from_numpy(np.stack(B))
    want, _ = dc._mxu_coarse_d2(p, frows, quad, RADIUS, lowp)
    got = torch.bmm(A, B)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(torch.int32).numpy())
    # the operands themselves, against the plain version's rounding
    if bf16:
        rhs = frows.to(torch.bfloat16).float()
    else:
        rhs = dc._tf32_rna(frows)
    np.testing.assert_array_equal(B.view(torch.int32).numpy(),
                                  rhs.view(torch.int32).numpy())


@pytest.mark.parametrize("tile", ["sf", "rows"])
@pytest.mark.parametrize("lowp", ["off", "bf16"])
def test_early_exit_gate_decides_as_the_minimum(request, tile, lowp):
    """The kernel's gate stops after the first group of GROUP n-tiles in
    which some product is <= thr; it passes exactly where the plain gate's
    cmin <= thr does, over _coarse_mxu_gate's products."""
    sp, pts = request.getfixturevalue(tile)
    p, frows, quad, _, _ = _gate_tiles(sp, pts)
    d2m, thr = dc._mxu_coarse_d2(p, frows, quad, RADIUS, lowp)
    first = None
    passed = torch.zeros(len(thr), dtype=torch.bool)
    cols = GROUP * 8
    for g0 in range(0, dc._SUB, cols):
        hit = (d2m[:, :, g0:g0 + cols] <= thr[:, None, None]).any(2).any(1)
        if first is None:
            first = hit.clone()
        passed |= hit
    np.testing.assert_array_equal(
        passed.numpy(), (d2m.amin(dim=(1, 2)) <= thr).numpy())
    if tile == "sf":        # the bound admits every voted tile, most early
        assert passed.all() and first.float().mean() > 0.5
    else:
        assert not passed.all()
