"""The host side of the exact sweep kernel (kernels/sweep_exact.cu), on the
CPU: its seg_sweep table, its chunk order (and a model of the rank kernel
that computes it on the card), and a torch model of its per-pair chain
with the division shortcut. Tolerance 0 throughout: the
kernel is held to the plain version bit for bit, so what it reads and
what it skips must change no bit of a kept (d², edge, offset).
"""

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.compiler import compile_network

pytestmark = pytest.mark.usefixtures("few_torch_threads")

def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _degenerate_pack():
    """Segments at the denominator's 1e-12 floor (zero length, and lengths
    whose squared norm underflows it) beside ordinary ones."""
    rng = np.random.default_rng(23)
    a = rng.uniform(-2000.0, 2000.0, (300, 2)).astype(np.float32)
    step = np.zeros((300, 2), np.float32)
    step[:100] = 0.0                                       # a == b
    step[100:200, 0] = np.float32(3e-7)                    # |ab|² < 1e-12
    step[200:] = rng.uniform(-80.0, 80.0, (100, 2))
    b = (a + step).astype(np.float32)
    n = len(a)
    return dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                             rng.uniform(0, 500, n).astype(np.float32),
                             np.linalg.norm(step, axis=1).astype(np.float32))


@pytest.fixture(scope="module")
def sf_pack():
    ts = compile_network(generate_city("sf"))
    return dc.build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                             ts.seg_len), ts


@pytest.mark.parametrize("tile", ["sf", "degenerate"])
def test_seg_sweep_equals_column_side(request, tile):
    """Every field of seg_sweep (numpy f32) equals the plain version's
    column-side intermediate (torch, _column_side of _block_geometry), bit
    for bit; floored denominators sit at f32(1e-12)."""
    sp = request.getfixturevalue("sf_pack")[0] if tile == "sf" \
        else _degenerate_pack()
    spad = sp.pack.shape[1]
    assert sp.sweep.shape == (spad, dc.SW_NCOMP)
    assert sp.sweep.dtype == np.float32 and sp.sweep.flags.c_contiguous
    cols = dc._column_side(torch.from_numpy(sp.pack))
    sweep = torch.from_numpy(sp.sweep)
    for field, want in enumerate(cols):
        np.testing.assert_array_equal(_bits(sweep[:, field]),
                                      _bits(want[0]), err_msg=str(field))
    floored = sp.sweep[:, dc.SW_DEN] == np.float32(1e-12)
    real = sp.pack[dc.SP_EDGE].view(np.int32) >= 0
    if tile == "degenerate":
        assert (floored & real).sum() >= 200
    assert floored[~real].all()


@pytest.mark.parametrize("tile", ["sf", "degenerate"])
def test_point_side_chain_on_seg_sweep_equals_block_geometry(request, tile):
    """The pair loop's point side, fed the table's column side, gives the
    plain version's d² and offsets bit for bit (without the shortcut)."""
    if tile == "sf":
        sp, ts = request.getfixturevalue("sf_pack")
        rng = np.random.default_rng(3)
        pts = np.concatenate([ts.node_xy[:200], rng.uniform(
            ts.node_xy.min(0), ts.node_xy.max(0), (200, 2))])
    else:
        sp = _degenerate_pack()
        rng = np.random.default_rng(4)
        pts = np.concatenate([
            sp.pack[[dc.SP_AX, dc.SP_AY], :300].T[:200],
            rng.uniform(-2000.0, 2000.0, (200, 2))])
    pts = torch.from_numpy(np.asarray(pts, np.float32))
    px, py = pts[:, 0:1], pts[:, 1:2]
    d2, edge, off = dc._block_geometry(px, py, torch.from_numpy(sp.pack))
    sw = torch.from_numpy(sp.sweep).T
    ax, ay, abx, aby, den = (sw[i:i + 1] for i in range(5))
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / den, 0.0, 1.0)
    dx = px - (ax + t * abx)
    dy = py - (ay + t * aby)
    np.testing.assert_array_equal(_bits(dx * dx + dy * dy), _bits(d2))
    np.testing.assert_array_equal(
        _bits(sw[dc.SW_OFF:dc.SW_OFF + 1] + t * sw[dc.SW_LEN:dc.SW_LEN + 1]),
        _bits(off))
    np.testing.assert_array_equal(
        sw[dc.SW_EDGE].contiguous().view(torch.int32).numpy(),
        edge[0].numpy())


@pytest.mark.parametrize("n", [1, 7, 512, 4096])
def test_chunk_order_is_stable_heaviest_first(n):
    """A permutation of the chunks by descending hit count, ties in index
    order: numpy's stable argsort of -nhits."""
    rng = np.random.default_rng(n)
    nhits = rng.integers(0, 14, n).astype(np.int32)
    got = dc._chunk_order(torch.from_numpy(nhits))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(-nhits, kind="stable"))
    assert sorted(got.tolist()) == list(range(n))
    assert (np.diff(nhits[got.numpy()]) <= 0).all()


@pytest.mark.parametrize("n", [1, 7, 300, 4096])
def test_chunk_order_ranks_equal_plain(n):
    """chunk_order_kernel's rule: chunk i goes to position #{j : nhits[j] >
    nhits[i]} + #{j < i : nhits[j] == nhits[i]}. Over hit counts with many
    ties, those positions are a permutation and place each chunk where
    _chunk_order does."""
    rng = np.random.default_rng(n + 1)
    nhits = rng.integers(0, 6, n).astype(np.int32)
    v, idx = nhits[:, None], np.arange(n)
    rank = ((nhits[None, :] > v) | ((nhits[None, :] == v)
                                    & (idx[None, :] < idx[:, None]))).sum(1)
    order = np.full(n, -1, np.int64)
    order[rank] = idx
    assert sorted(rank.tolist()) == list(range(n))
    np.testing.assert_array_equal(
        order, dc._chunk_order(torch.from_numpy(nhits)).numpy())


def _kernel_pairs(px, py, sw):
    """A torch model of the kernel's per-pair chain on seg_sweep columns
    ([8, C], SW_* rows): t by the clamp shortcut (0 where num <= 0, 1 where
    num >= denom, the clamped quotient elsewhere, NaN included) →
    (t, d², offset)."""
    ax, ay, abx, aby, den = (sw[i:i + 1] for i in range(5))
    num = (px - ax) * abx + (py - ay) * aby
    divide = ~(num <= 0) & ~(num >= den)
    t = torch.where(divide, torch.clamp(num / den, 0.0, 1.0),
                    torch.where(num <= 0, 0.0, 1.0))
    dx = px - (ax + t * abx)
    dy = py - (ay + t * aby)
    return t, dx * dx + dy * dy, \
        sw[dc.SW_OFF:dc.SW_OFF + 1] + t * sw[dc.SW_LEN:dc.SW_LEN + 1]


def _adversarial():
    """Segments and, per segment, points whose numerator lies within a few
    ulps of 0 (beside the start, off the line) and of the denominator
    (beside the end): the point walks ulp by ulp along the segment's
    direction across each clamp boundary."""
    rng = np.random.default_rng(31)
    n = 24
    a = rng.uniform(-1500.0, 1500.0, (n, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    length = rng.uniform(0.5, 300.0, n)
    u = np.stack([np.cos(ang), np.sin(ang)], 1)
    b = (a + u * length[:, None]).astype(np.float32)
    perp = np.stack([-u[:, 1], u[:, 0]], 1)
    pts = []
    for i in range(n):
        for end in (a[i], b[i]):
            for off in (0.0, 3.0, 40.0):
                base = (end + perp[i] * off).astype(np.float32)
                for k in range(-6, 7):
                    p = base.copy()
                    for _ in range(abs(k)):      # k ulps along u
                        p = np.nextafter(p, p + np.sign(k) * u[i]).astype(
                            np.float32)
                    pts.append(p)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           rng.uniform(0, 100, n).astype(np.float32),
                           np.linalg.norm(b - a, axis=1).astype(np.float32),
                           split_len=0.0)
    return sp, np.asarray(pts, np.float32)


def test_pair_shortcut_model_equals_plain_chain():
    """The shortcut (no division where t clamps) against the plain chain,
    bit for bit in d² and in the offset, over pairs whose numerator sits
    on either side of 0 and of the denominator by an ulp or a few."""
    sp, pts = _adversarial()
    pts = torch.from_numpy(pts)
    px, py = pts[:, 0:1], pts[:, 1:2]
    pack = torch.from_numpy(sp.pack)
    d2, _, off = dc._block_geometry(px, py, pack)
    sw = torch.from_numpy(sp.sweep).T.contiguous()
    t, got_d2, got_off = _kernel_pairs(px, py, sw)
    np.testing.assert_array_equal(_bits(got_d2), _bits(d2))
    np.testing.assert_array_equal(_bits(got_off), _bits(off))
    plain_t = torch.clamp(
        ((px - sw[0:1]) * sw[2:3] + (py - sw[1:2]) * sw[3:4]) / sw[4:5],
        0.0, 1.0)
    np.testing.assert_array_equal(t.numpy(), plain_t.numpy())
    # the inputs reach both sides of both boundaries, within a few ulps:
    # of the products the numerator cancels (near 0), of the denominator
    m1 = (px - sw[0:1]) * sw[2:3]
    m2 = (py - sw[1:2]) * sw[3:4]
    num = m1 + m2
    real = torch.from_numpy(sp.pack[dc.SP_EDGE].view(np.int32) >= 0)
    m1, m2, num = m1[:, real], m2[:, real], num[:, real]
    den = sw[4:5, real].expand_as(num)

    def ulp(x):
        return torch.nextafter(x, torch.full_like(x, float("inf"))) - x

    near0 = num.abs() <= 4 * ulp(torch.maximum(m1.abs(), m2.abs()))
    near1 = (num - den).abs() <= 4 * ulp(den)
    counts = [int(v.sum()) for v in (num == 0, near0 & (num < 0),
                                     near0 & (num > 0), num == den,
                                     near1 & (num < den), near1 & (num > den))]
    assert min(counts) > 0, counts
