"""The sweep's coarse-filter arms in the port: the pack's feat rows, the
arms' candidates, the plain gates and the arm dispatch, against the JAX
package on the CPU.

Tolerances. The feat rows are byte-equal (tolerance 0). Candidates: the
port's CPU path is the plain sweep for every arm, and the JAX package's
arms run as Pallas kernels in interpret mode (``_INTERPRET``, ``_SBLK =
128``, ``_SUB = 64``, as tests/test_dense_candidates.py runs them), whose
XLA:CPU arithmetic contracts multiply-adds into FMAs: the contract of
test_torch_dense_candidates.py's ``_assert_close`` holds (per point the
same edges except within 1e-4 m of a cut; per shared edge |Δdist| and
|Δoffset| ≤ 1e-3 m). The plain gates are held to conservativeness with
no slack: no in-radius pair may score above its slice's threshold.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import CompilerParams
from reporter_tpu.ops import dense_candidates as jdc
from reporter_tpu.netgen.network import RoadNetwork, Way
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.ops import dense_candidates as dc
from _torch_support import few_torch_threads  # noqa: F401
from test_torch_dense_candidates import _assert_close, _boundary_points

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RADIUS, K = 50.0, 8
COARSE = ("bf16_filter", "mxu_tf32", "mxu_bf16")


@pytest.fixture(scope="module")
def ts():
    return compile_network(generate_city("tiny", seed=11), CompilerParams())


def _split_tile():
    xy = np.array([[-1000.0, 0.0], [1000.0, 0.0], [1000.0, 150.0],
                   [-1000.0, -150.0], [0.0, 140.0]])
    net = RoadNetwork(node_lonlat=xy_to_lonlat(xy, np.array([-122.3, 37.8])),
                      ways=[Way(way_id=1, nodes=[0, 1], speed_mps=29.0),
                            Way(way_id=2, nodes=[1, 2]),
                            Way(way_id=3, nodes=[0, 3]),
                            Way(way_id=4, nodes=[4, 1])])
    return compile_network(net, CompilerParams(reach_radius=400.0))


def _args(t):
    return (t.seg_a, t.seg_b, t.seg_edge, t.seg_off, t.seg_len)


@pytest.mark.parametrize("tile,split_len", [("tiny", dc.SPLIT_LEN),
                                            ("split", dc.SPLIT_LEN),
                                            ("split", 0.0)])
def test_seg_pack_feat_byte_equal(ts, tile, split_len):
    t = ts if tile == "tiny" else _split_tile()
    a = dc.build_seg_pack(*_args(t), split_len=split_len)
    b = jdc.build_seg_pack(*_args(t), split_len=split_len)
    assert a.feat.dtype == b.feat.dtype == np.float32
    assert a.feat.tobytes() == b.feat.tobytes()
    assert (a.feat[dc.SF_F][a.pack[dc.SP_EDGE].view(np.int32) < 0]
            == np.float32(dc.BIG)).all()


def _point_sets(t):
    rng = np.random.default_rng(7)
    lo, hi = t.node_xy.min(0), t.node_xy.max(0)
    n = 96

    def pad(p):
        p = np.asarray(p, np.float32)
        return np.tile(p, (-(-n // len(p)), 1))[:n]

    local = pad(np.concatenate([lo + rng.uniform(0, 40.0, (64, 2)),
                                t.node_xy[:32]]))
    spread = pad(np.concatenate([rng.uniform(lo - 30, hi + 30, (32, 2)),
                                 t.node_xy[:16], _boundary_points(t, rng, 48)]))
    return {"local": local, "spread": spread}


@pytest.mark.parametrize("levers", [dict(lowp="bf16"), dict(mxu=True),
                                    dict(mxu=True, lowp="bf16")],
                         ids=["sub_bf16", "mxu", "mxu_bf16"])
def test_coarse_arms_match_interpret_kernels(ts, monkeypatch, levers):
    """Both point sets of the JAX interpret parity test (a corner cluster
    with exact node ties; tile-wide points with 48-52 m radius-boundary
    points) through the JAX arm's Pallas kernel and the port's arm."""
    monkeypatch.setattr(jdc, "_INTERPRET", True)
    monkeypatch.setattr(jdc, "_SBLK", 128)
    monkeypatch.setattr(jdc, "_SUB", 64)
    monkeypatch.setattr(jdc, "_NJ_CAP", 8)        # the cond lifted: one trace
    jsp = jdc.build_seg_pack(*_args(ts), block=128)
    sp = dc.build_seg_pack(*_args(ts))
    for name, pts in _point_sets(ts).items():
        ref = jdc.find_candidates_dense(
            jnp.asarray(pts), tuple(jnp.asarray(x) for x in jsp), RADIUS, K,
            **levers)
        got = dc.find_candidates_dense(
            torch.from_numpy(pts), tuple(torch.from_numpy(x) for x in sp),
            RADIUS, K, **levers)
        dd, do, flips = _assert_close(
            [np.asarray(x) for x in (ref.edge, ref.offset, ref.dist)],
            [x.numpy() for x in (got.edge, got.offset, got.dist)])
        print(f"{levers} {name}: max|Δdist| {dd:.3g} m, max|Δoffset| "
              f"{do:.3g} m, {flips} cut flips")


@pytest.mark.parametrize("levers,pack_len", [
    (dict(subcull=False, lowp="bf16"), 4),
    (dict(subcull=False, mxu=True), 4),
    (dict(subcull=False, mxu=True, lowp="bf16"), 4),
    (dict(mxu=True), 3),
    (dict(lowp="bf16"), 2),
    (dict(), 2),
    (dict(subcull=False), 4),
    (dict(mxu=True, lowp="bf16"), 4),
])
def test_illegal_arm_combinations_raise_alike(ts, monkeypatch, levers,
                                               pack_len):
    """The port raises exactly where the JAX kernel dispatch does. The JAX
    dispatch checks its arguments first and then calls _chunk_block_ids,
    which is replaced here by a sentinel, so no legal case runs the slow
    interpreter."""

    class Passed(Exception):
        pass

    def sentinel(*a, **kw):
        raise Passed

    monkeypatch.setattr(jdc, "_INTERPRET", True)
    monkeypatch.setattr(jdc, "_chunk_block_ids", sentinel)
    pts = ts.node_xy[:4].astype(np.float32)
    jsp = tuple(jnp.asarray(x) for x in jdc.build_seg_pack(*_args(ts)))
    sp = tuple(torch.from_numpy(x) for x in dc.build_seg_pack(*_args(ts)))
    try:
        jdc.find_candidates_dense(jnp.asarray(pts), jsp[:pack_len], RADIUS, K,
                                  **levers)
        raise AssertionError("the JAX dispatch neither raised nor ran")
    except Passed:
        jerr = None
    except ValueError as exc:
        jerr = str(exc)
    try:
        dc.find_candidates_dense(torch.from_numpy(pts), sp[:pack_len],
                                 RADIUS, K, **levers)
        err = None
    except ValueError as exc:
        err = str(exc)
    assert (jerr is None) == (err is None), (jerr, err)
    if err is not None:
        assert err.split(" requires")[0] == jerr.split(" requires")[0]


def _random_pack(seed=17, n=400):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 3000.0, (n, 2)).astype(np.float32)
    span = rng.uniform(0.01, 600.0, (n, 1)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (n, 1))
    b = (a + span * np.concatenate([np.cos(ang), np.sin(ang)], 1)
         ).astype(np.float32)
    seg_len = np.linalg.norm(b - a, axis=1).astype(np.float32)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           np.zeros(n, np.float32), seg_len)
    pts = np.concatenate([
        a[:80] + rng.uniform(-60, 60, (80, 2)).astype(np.float32),
        a[:40],
        rng.uniform(-5000, 8000, (40, 2)).astype(np.float32)]).astype(np.float32)
    return sp, pts


def _coarse_pairs(kind, p, sp, cols, quad):
    """One slice's pair values and threshold for every point in ``p``."""
    pt = torch.from_numpy(p)[None]
    q = torch.from_numpy(quad)[None]
    if kind == "bf16_filter":
        return dc._bf16_coarse_d2(pt, torch.from_numpy(sp.pack[:, cols])[None],
                                  q, RADIUS)
    return dc._mxu_coarse_d2(pt, torch.from_numpy(sp.feat[:, cols])[None], q,
                             RADIUS, "bf16" if kind == "mxu_bf16" else "off")


@pytest.mark.parametrize("kind", COARSE)
def test_coarse_pass_is_conservative(kind):
    """The JAX package's margin fuzz, on the port's plain coarse passes:
    400 random segments (mixed lengths, some split, near-degenerate ones)
    and points near them, at endpoints (d = 0 ties) and far away (the
    clamp regime). No pair within the radius may score above its slice's
    threshold, in every operand rounding the kernel uses."""
    sp, pts = _random_pack()
    edges = sp.pack[dc.SP_EDGE].view(np.int32)
    a64 = np.stack([sp.pack[dc.SP_AX], sp.pack[dc.SP_AY]], 1).astype(np.float64)
    d64 = np.stack([sp.pack[dc.SP_BX], sp.pack[dc.SP_BY]], 1).astype(
        np.float64) - a64
    denom = np.maximum((d64 * d64).sum(1), 1e-12)
    checked = 0
    for blk in range(sp.sub.shape[0]):
        for s in range(dc._SBLK // dc._SUB):
            quad = sp.sub[blk, 4 * s:4 * s + 4]
            cols = slice(blk * dc._SBLK + s * dc._SUB,
                         blk * dc._SBLK + (s + 1) * dc._SUB)
            if np.isnan(quad).any():
                continue
            d2, thr = _coarse_pairs(kind, pts, sp, cols, quad)
            d2, thr = d2[0].numpy(), float(thr[0])
            real = edges[cols] >= 0
            ai, di, den = a64[cols][real], d64[cols][real], denom[cols][real]
            t = np.clip(((pts[:, None, :] - ai[None]) * di[None]).sum(-1)
                        / den[None], 0.0, 1.0)
            dseg2 = ((pts[:, None, :] - (ai[None] + t[..., None] * di[None]))
                     ** 2).sum(-1)
            inr = dseg2 <= RADIUS * RADIUS
            assert (d2[:, :real.sum()][inr] <= thr).all(), (blk, s)
            checked += int(inr.sum())
    assert checked > 300


@pytest.mark.parametrize("kind", COARSE)
def test_coarse_gate_actually_culls(kind):
    """The gate's other edge: points inside a sparse slice's bbox (so the
    bbox vote admits them) but hundreds of metres from its lines must
    score above the threshold — an always-admit gate would pass every
    parity test and only cost time."""
    n = 4
    a = np.stack([np.arange(n) * 12.0, np.zeros(n)], 1).astype(np.float32)
    b = (a + np.float32(400.0)).astype(np.float32)
    seg_len = np.linalg.norm(b - a, axis=1).astype(np.float32)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           np.zeros(n, np.float32), seg_len, split_len=0.0)
    quad = sp.sub[0, 0:4]
    assert not np.isnan(quad).any()
    pts = np.array([[380.0, 20.0], [410.0, 40.0], [350.0, 5.0]], np.float32)
    d2, thr = _coarse_pairs(kind, pts, sp, slice(0, dc._SUB), quad)
    assert float(d2.min()) > float(thr[0]), (float(d2.min()), float(thr[0]))


@pytest.mark.parametrize("kind", COARSE)
def test_plain_gates_admit_every_warp_with_a_pair(kind):
    """The per-warp gates as the kernel applies them, at the kernel's
    512/128 blocking: 2048 short random segments over a 4 km square, and
    64 warps of 32 points, each warp a patch of 80 m as Morton-sorted
    traces give. Every (warp, hit slice) holding a pair within the radius
    passes its vote and its gate; the bf16 filter skips some voted slices."""
    rng = np.random.default_rng(5)
    n = 2048
    a = rng.uniform(0, 4000.0, (n, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (n, 1))
    b = (a + rng.uniform(10.0, 80.0, (n, 1)) * np.concatenate(
        [np.cos(ang), np.sin(ang)], 1)).astype(np.float32)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           np.zeros(n, np.float32),
                           np.linalg.norm(b - a, axis=1).astype(np.float32))
    centres = rng.uniform(0, 4000.0, (64, 1, 2))
    pts = (centres + rng.uniform(-40.0, 40.0, (64, 32, 2))).reshape(-1, 2)
    pts = torch.from_numpy(pts.astype(np.float32))
    pack, bbox, sub, feat = (torch.from_numpy(x) for x in sp[:4])
    nchunks = len(pts) // dc._P
    ids, nhits = dc._chunk_block_ids(pts, torch.ones(len(pts), dtype=bool),
                                     bbox, RADIUS, nchunks)
    if kind == "bf16_filter":
        log = dc._coarse_bf16_gate(pts, ids, nhits, pack, sub, RADIUS)
    else:
        log = dc._coarse_mxu_gate(pts, ids, nhits, sub, feat, RADIUS,
                                  "bf16" if kind == "mxu_bf16" else "off")
    # exact in-radius pairs per (chunk, warp, slot, slice)
    d2, edge, _ = dc._block_geometry(pts[:, 0:1], pts[:, 1:2], pack)
    inr = (edge >= 0) & (d2 <= RADIUS * RADIUS)            # [N, S]
    nsub = dc._SBLK // dc._SUB
    per = inr.reshape(nchunks, dc._P // 32, 32, -1, nsub, dc._SUB).any(5).any(2)
    want = torch.zeros_like(log.gate)
    for c in range(nchunks):
        for j in range(int(nhits[c])):
            want[c, :, j] = per[c, :, int(ids[c, j])]
    assert int(want.sum()) > 50
    assert (log.gate | ~want).all()
    assert (log.vote | ~log.gate).all()
    print(f"{kind}: {int(want.sum())} warp slices with a pair, "
          f"{int(log.gate.sum())} gated in, {int(log.vote.sum())} voted")
    if kind == "bf16_filter":
        # the tensor-core pass bounds by the infinite line, which with
        # random directions passes near every patch: its culling is
        # pinned by test_coarse_gate_actually_culls instead
        assert int(log.gate.sum()) < int(log.vote.sum())
