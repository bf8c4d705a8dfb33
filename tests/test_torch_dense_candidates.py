"""The port's dense candidate search (plain PyTorch path on the CPU)
against the JAX package's find_candidates_dense, and against an
independent numpy sweep of the same f32 arithmetic.

Tolerance. On a CPU backend the JAX function runs _dense_jnp, and XLA:CPU
contracts ``a*b + c`` into fused multiply-adds. The port keeps every
operation a separate IEEE rounding, as its CUDA kernel does (built with
-fmad=false), so the two differ by a few f32 ulps of the tile
coordinates. Measured by test_dense_vs_reference on its inputs (printed
with -s): max |Δdist| 3.05e-5 m, max |Δoffset| 3.81e-5 m, and 2 of the
137 points at 48-52 m keep a different edge at the radius; exact node
coordinates (d = 0 ties) agree to the bit. Twin directed edges (the two
directions of one two-way street) tie in exact arithmetic, so their slot
order follows the rounding. Asserted: per point, the same edges except
at a cut (within 1e-4 m of the radius or of the K-th distance), and per
shared edge |Δdist| and |Δoffset| ≤ 1e-3 m. Against the numpy sweep of
the port's own arithmetic the tolerance is 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import CompilerParams
from reporter_tpu.geometry import xy_to_lonlat
from reporter_tpu.netgen.network import RoadNetwork, Way
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops.dense_candidates import (
    find_candidates_dense as j_find_candidates_dense)
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu_torch.ops.dense_candidates import (BIG, build_seg_pack,
                                                     find_candidates_dense)
from _torch_support import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RADIUS, K = 50.0, 8
CUT_TOL = 1e-4      # m: how close to the K-th / radius cut a set flip may be
FIELD_TOL = 1e-3    # m: |Δdist|, |Δoffset| per shared edge


@pytest.fixture(scope="module")
def ts():
    return compile_network(generate_city("tiny", seed=11), CompilerParams())


def _both(ts_, pts, **pack_kw):
    sp = build_seg_pack(ts_.seg_a, ts_.seg_b, ts_.seg_edge, ts_.seg_off,
                        ts_.seg_len, **pack_kw)
    ref = j_find_candidates_dense(jnp.asarray(pts),
                                  (jnp.asarray(sp.pack), jnp.asarray(sp.bbox)),
                                  RADIUS, K)
    got = find_candidates_dense(torch.from_numpy(pts),
                                tuple(torch.from_numpy(x) for x in sp),
                                RADIUS, K)
    return ([np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
            [x.numpy() for x in (got.edge, got.offset, got.dist)])


def _assert_close(ref, got):
    """Asserts the stated contract; returns (max |Δdist|, max |Δoffset|
    over shared edges, number of set flips at a cut)."""
    (je, jo, jd), (e, o, d) = ref, got
    assert e.dtype == np.int32 and o.dtype == d.dtype == np.float32
    dd = do = 0.0
    flips = 0
    for i in range(len(e)):
        a = {int(x): (jd[i, k], jo[i, k]) for k, x in enumerate(je[i]) if x >= 0}
        b = {int(x): (d[i, k], o[i, k]) for k, x in enumerate(e[i]) if x >= 0}
        for x in a.keys() & b.keys():
            dd = max(dd, float(abs(a[x][0] - b[x][0])))
            do = max(do, float(abs(a[x][1] - b[x][1])))
            assert abs(a[x][0] - b[x][0]) <= FIELD_TOL, (i, x)
            assert abs(a[x][1] - b[x][1]) <= FIELD_TOL, (i, x)
        for x in a.keys() ^ b.keys():
            flips += 1
            dist = a[x][0] if x in a else b[x][0]
            other = b if x in a else a
            cut = max(v[0] for v in other.values()) if len(other) == K else RADIUS
            assert min(abs(dist - RADIUS), abs(dist - cut)) <= CUT_TOL, (i, x)
        # the port's own slot order: distance non-decreasing, pads last
        live = d[i][e[i] >= 0]
        assert (np.diff(live) >= 0).all() and (e[i][len(live):] == -1).all()
        assert (d[i][len(live):] == np.float32(BIG)).all()
        assert (o[i][len(live):] == 0).all()
    return dd, do, flips


def _numpy_sweep(ts_, pts):
    """Independent numpy form of the port's arithmetic: one f32 rounding
    per operation in the reference's order; per edge the smallest d² and
    its smallest tied offset; top-K by (d², edge id)."""
    a, b = ts_.seg_a.astype(np.float32), ts_.seg_b.astype(np.float32)
    ax, ay, bx, by = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    abx, aby = bx - ax, by - ay
    denom = np.maximum(abx * abx + aby * aby, np.float32(1e-12))
    edge = np.full((len(pts), K), -1, np.int32)
    off = np.zeros((len(pts), K), np.float32)
    dist = np.full((len(pts), K), np.float32(BIG), np.float32)
    for i, (px, py) in enumerate(pts):
        t = np.clip(((px - ax) * abx + (py - ay) * aby) / denom,
                    np.float32(0), np.float32(1))
        dx = px - (ax + t * abx)
        dy = py - (ay + t * aby)
        d2 = dx * dx + dy * dy
        offabs = ts_.seg_off + t * ts_.seg_len
        best: dict[int, tuple] = {}
        for s in np.nonzero(d2 <= np.float32(RADIUS * RADIUS))[0]:
            e, key = int(ts_.seg_edge[s]), (d2[s], offabs[s])
            if e not in best or key < best[e]:
                best[e] = key
        top = sorted(best.items(), key=lambda kv: (kv[1][0], kv[0]))[:K]
        for k, (e, (dd, oo)) in enumerate(top):
            edge[i, k], off[i, k], dist[i, k] = e, oo, np.sqrt(dd)
    return edge, off, dist


def _boundary_points(ts_, rng, n=48):
    mid = ((ts_.seg_a + ts_.seg_b) * 0.5)[:n]
    ang = rng.uniform(0, 2 * np.pi, len(mid))
    r = rng.uniform(48.0, 52.0, len(mid))[:, None]
    return mid + np.stack([np.cos(ang), np.sin(ang)], 1) * r


def test_sqrt_f32_is_correctly_rounded():
    """The plain version's square root rounds like numpy's f32 sqrt and
    CUDA's sqrtf (PyTorch's vectorized CPU sqrt does not, on a fraction
    of inputs, and which ones depends on its thread chunking)."""
    from reporter_tpu_torch.ops.dense_candidates import sqrt_f32

    rng = np.random.default_rng(0)
    x = (rng.random(500_000) * 10.0 ** rng.uniform(-6, 8, 500_000)
         ).astype(np.float32)
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_plain_sweep_equals_numpy_arithmetic(ts):
    """Tolerance 0: the plain path is exactly the stated f32 arithmetic,
    the same the CUDA kernel is held to on the card."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([
        rng.uniform(ts.node_xy.min(0) - 30, ts.node_xy.max(0) + 30, (64, 2)),
        ts.node_xy[:16], _boundary_points(ts, rng, 32)]).astype(np.float32)
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    got = find_candidates_dense(torch.from_numpy(pts),
                                tuple(torch.from_numpy(x) for x in sp),
                                RADIUS, K)
    want = _numpy_sweep(ts, pts)
    for g, w in zip((got.edge, got.offset, got.dist), want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got.valid.numpy(), want[0] >= 0)


@pytest.mark.parametrize("kind", ["uniform", "fleet", "nodes", "radius_48_52"])
def test_dense_vs_reference(ts, kind):
    rng = np.random.default_rng(7)
    if kind == "uniform":
        pts = rng.uniform(ts.node_xy.min(0) - 30, ts.node_xy.max(0) + 30,
                          (400, 2))
    elif kind == "fleet":
        pts = np.concatenate([p.xy for p in
                              synthesize_fleet(ts, 6, num_points=60, seed=5)])
    elif kind == "nodes":        # exact node coordinates: d = 0 ties
        pts = ts.node_xy
    else:
        pts = _boundary_points(ts, rng, 137)
    ref, got = _both(ts, np.asarray(pts, np.float32))
    dd, do, flips = _assert_close(ref, got)
    print(f"{kind}: max|Δdist| {dd:.3g} m, max|Δoffset| {do:.3g} m, "
          f"{flips} cut flips of {len(pts)} points")


def test_tie_break_at_star_junction():
    """12 ways meet at one node: a query at the node ties every incident
    edge at d = 0 exactly; the K smallest edge ids are kept, in order, by
    both packages."""
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    xy = np.vstack([[0.0, 0.0], np.stack([np.cos(ang), np.sin(ang)], 1) * 200.0])
    net = RoadNetwork(node_lonlat=xy_to_lonlat(xy, np.array([-122.4, 37.75])),
                      ways=[Way(way_id=i + 1, nodes=[0, i + 1]) for i in range(12)],
                      name="star")
    sts = compile_network(net, CompilerParams(cell_size=64.0))
    pt = sts.node_xy[0:1].astype(np.float32)
    (je, jo, jd), (e, o, d) = _both(sts, pt)
    assert (e >= 0).sum() == K
    np.testing.assert_array_equal(e, je)
    assert list(e[0]) == sorted(e[0])
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(o, jo)


def test_long_segment_split():
    """Multi-km edges are split before packing; candidates on the split
    pack equal the unsplit pack's as edge sets, and the reference's."""
    xy = np.array([[-1000.0, 0.0], [1000.0, 0.0], [1000.0, 150.0],
                   [-1000.0, -150.0], [0.0, 140.0]])
    net = RoadNetwork(node_lonlat=xy_to_lonlat(xy, np.array([-122.3, 37.8])),
                      ways=[Way(way_id=1, nodes=[0, 1], speed_mps=29.0),
                            Way(way_id=2, nodes=[1, 2]),
                            Way(way_id=3, nodes=[0, 3]),
                            Way(way_id=4, nodes=[4, 1])])
    lts = compile_network(net, CompilerParams(reach_radius=400.0))
    rng = np.random.default_rng(2)
    pts = np.vstack([rng.uniform([-1100, -250], [1100, 250], (200, 2)),
                     lts.node_xy[[0, 1]]]).astype(np.float32)
    ref, got = _both(lts, pts)
    _assert_close(ref, got)
    np.testing.assert_array_equal(got[0][-2:], ref[0][-2:])   # node ties
    _, unsplit = _both(lts, pts, split_len=0.0)
    for i in range(len(pts)):
        assert (set(got[0][i][got[0][i] >= 0].tolist())
                == set(unsplit[0][i][unsplit[0][i] >= 0].tolist())), i


# ---------------------------------------------------------------------------
# The top-K width a CUDA sweep runs at (sweep_instance_k)


def test_sweep_instance_k_picks_the_next_built_width():
    """K in SWEEP_KS runs itself; any other K up to the largest runs the
    smallest built K' >= K; K < 1 or past the largest raises naming the
    set."""
    from reporter_tpu_torch.ops.dense_candidates import (SWEEP_KS,
                                                         sweep_instance_k)

    for k in range(1, SWEEP_KS[-1] + 1):
        kk = sweep_instance_k(k)
        assert kk in SWEEP_KS and kk >= k
        assert kk == min(x for x in SWEEP_KS if x >= k), k
    for k in SWEEP_KS:
        assert sweep_instance_k(k) == k
    assert [sweep_instance_k(k) for k in (5, 7, 10)] == [6, 8, 12]
    for k in (0, -1, SWEEP_KS[-1] + 1, 32):
        with pytest.raises(ValueError, match=r"K in \(4, 6, 8, 12, 16\)"):
            sweep_instance_k(k)


def test_first_k_columns_of_a_wider_sweep_are_the_sweep_at_k(ts):
    """What makes the mapping exact: the list is kept in (d², edge id)
    order over distinct edges, so the first k columns of the sweep at K'
    equal the sweep at k, ties (every node: d = 0) and empty slots
    included. Held on the plain version, whose order the kernel's is
    bit-equal to on the card (tests/test_torch_kernels_gpu.py)."""
    from reporter_tpu_torch.ops.dense_candidates import (_dense_plain,
                                                         sweep_instance_k)

    rng = np.random.default_rng(5)
    pts = np.concatenate([
        ts.node_xy, _boundary_points(ts, rng),
        rng.uniform(ts.node_xy.min(0) - 60, ts.node_xy.max(0) + 60,
                    (400, 2))]).astype(np.float32)
    sp = build_seg_pack(ts.seg_a, ts.seg_b, ts.seg_edge, ts.seg_off,
                        ts.seg_len)
    pack = torch.from_numpy(sp.pack)
    p = torch.from_numpy(pts)
    wide = {kk: _dense_plain(p, pack, RADIUS, kk) for kk in (4, 6, 8, 12, 16)}
    for k in range(1, 17):
        want = _dense_plain(p, pack, RADIUS, k)
        got = wide[sweep_instance_k(k)]
        for g, w in zip(got, want):
            assert torch.equal(g[:, :k], w), k
