"""The CUDA sweep kernel (reporter_tpu_torch/kernels/sweep_exact.cu, its
five arms at each top-K width of SWEEP_KS) against its plain PyTorch
versions, on the card, and the native host half of match_many there.
Candidates, every arm and K: tolerance 0
(the same f32 arithmetic, one rounding per operation). The bf16 filter's
gate decisions: tolerance 0 (every bf16 operation is correctly rounded on
both sides). The tensor-core gate: a decision may differ from the plain
f32 product only where the plain minimum lies within 1e-3 of the
threshold (the tensor cores sum the eight products in another order).

Marked ``gpu``: the kernel is compiled by nvcc and runs only on a CUDA
device, so each test skips without one. This file imports no JAX, so it
runs on the machine with the card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops import dense_candidates as dc
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import tables_from_numpy

pytestmark = pytest.mark.gpu

GATE_REL_TOL = 1e-3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU form")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sf_tile(cuda):
    ts = compile_network(generate_city("sf"))
    return ts, tables_from_numpy(ts.arrays(), cuda)


@pytest.fixture(scope="module")
def sf(sf_tile, cuda):
    """The sf tile's tables and a point set: fleet traces, every node (d =
    0 ties) and uniform points past the tile's edge; 10% invalid."""
    ts, tab = sf_tile
    rng = np.random.default_rng(0)
    fleet = np.concatenate([p.xy for p in synthesize_fleet(ts, 64, seed=3)])
    pts = np.concatenate([
        fleet, ts.node_xy,
        rng.uniform(ts.node_xy.min(0) - 60, ts.node_xy.max(0) + 60, (4000, 2))])
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    valid = torch.rand(len(pts), generator=torch.Generator().manual_seed(1)) < 0.9
    return tab, pts, valid.to(cuda)


@pytest.mark.parametrize("arm", dc.SWEEP_ARMS)
def test_sweep_kernel_equals_plain(sf, arm):
    tab, pts, valid = sf
    levers = {"block": dict(subcull=False), "sub": {},
              "sub_bf16": dict(lowp="bf16"), "mxu": dict(mxu=True),
              "mxu_bf16": dict(mxu=True, lowp="bf16")}[arm]
    before = dc.SWEEP_LAUNCHES[arm, 8]
    got = dc.find_candidates_dense(
        pts, (tab["seg_pack"], tab["seg_bbox"], tab["seg_sub"],
              tab["seg_feat"], tab["seg_sweep"], tab["seg_coarse"]), 50.0, 8,
        valid=valid,
        **levers)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8)
    torch.cuda.synchronize()
    assert dc.SWEEP_LAUNCHES[arm, 8] == before + 1
    for g, r in zip((got.edge, got.offset, got.dist), ref):
        assert torch.equal(g[valid], r[valid])


@pytest.mark.parametrize("k", dc.SWEEP_KS)
@pytest.mark.parametrize("arm", dc.SWEEP_ARMS)
def test_sweep_kernel_equals_plain_at_every_k(sf, arm, k):
    """Each arm at each top-K width of SWEEP_KS, bit-equal to _dense_plain
    at that K on the valid points."""
    tab, pts, valid = sf
    n = len(pts)
    nchunks = -(-n // dc._P)
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], 50.0,
                                     nchunks)
    got = dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                        tab["seg_coarse"], 50.0, k, arm)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, k)
    for g, r in zip(got, ref):
        assert g.shape == (nchunks * dc._P, k)
        assert torch.equal(g[:n][valid], r[valid])


@pytest.fixture(scope="module")
def sf_fleet(sf_tile, cuda):
    """1024 fleet traces of 120 points, each padded to 128 with its first
    point: 131,072 points in 512 chunks, more than the persistent grid of
    every arm at every K."""
    ts, _ = sf_tile
    fleet = synthesize_fleet(ts, 1024, num_points=120, seed=5)
    pts = np.zeros((len(fleet), 128, 2), np.float32)
    for i, p in enumerate(fleet):
        pts[i, :len(p.xy)] = p.xy
        pts[i, len(p.xy):] = p.xy[0]
    return torch.from_numpy(pts.reshape(-1, 2)).to(cuda)


@pytest.mark.parametrize("k", dc.SWEEP_KS)
def test_sweep_past_the_grid_at_every_k(sf_tile, sf_fleet, k):
    """At each K, more chunks than the persistent grid, so CTAs take a
    second chunk and more (the chunk counter, the top-K list's reset
    between chunks, the ring's phase across chunks): each arm bit-equal to
    _dense_plain on every point."""
    from reporter_tpu_torch.kernels import build

    _, tab = sf_tile
    pts = sf_fleet
    nchunks = len(pts) // dc._P
    ids, nhits = dc._chunk_block_ids(
        pts, torch.ones(len(pts), dtype=torch.bool, device=pts.device),
        tab["seg_bbox"], 50.0, nchunks)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, k)
    for arm in dc.SWEEP_ARMS:
        sh = build.exact_shape(dc.SWEEP_ARMS.index(arm), k)
        assert nchunks > sh["ctas_per_sm"] * sh["sms"]
        got = dc.sweep_topk(pts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                            tab["seg_coarse"], 50.0, k, arm)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), arm


def test_sweep_rejects_k_outside_the_set(sf):
    tab, pts, _ = sf
    fpts = pts[:dc._P].contiguous()
    ids, nhits = dc._chunk_block_ids(
        fpts, torch.ones(dc._P, dtype=torch.bool, device=pts.device),
        tab["seg_bbox"], 50.0, 1)
    for k in (1, 5, 7, 9, 32):
        with pytest.raises(ValueError, match="K in"):
            dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                          tab["seg_coarse"], 50.0, k, "sub")


def test_native_match_many_on_the_card_equals_python_walk(sf_tile, cuda):
    """The tuned path's host half on the card: match_many (C prepare,
    overlapped harvest, C column walk) against the Python walk of the same
    decoded traces, record for record."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.api import (MatchBatch, SegmentMatcher,
                                                Trace, walk_python)

    ts, _ = sf_tile
    m = SegmentMatcher(ts, MatcherParams(sweep_autotune=False,
                                         max_device_batch=48))
    traces = [Trace(p.uuid, p.xy.astype(np.float32), p.times)
              for p in synthesize_fleet(ts, 128, seed=9)]
    got = m.match_many(traces)
    assert isinstance(got, MatchBatch)
    want = walk_python(ts, traces, m._decode_many(traces), m._route_fn,
                       m.params.backward_slack)
    assert [[r.to_json() for r in x] for x in got] == \
        [[r.to_json() for r in x] for x in want]
    assert got.n_records > 3 * len(traces)


def _kernel_gate(tab, pts, valid, arm):
    n = len(pts)
    nchunks = -(-n // dc._P)
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], 50.0,
                                     nchunks)
    log = torch.zeros((nchunks, dc._P // 32, ids.shape[1]), dtype=torch.int32,
                      device=pts.device)
    dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                  tab["seg_coarse"], 50.0, 8, arm, gate_log=log)
    torch.cuda.synchronize()
    return fpts, ids, nhits, dc.decode_gate_log(log), log


def test_bf16_gate_equals_plain(sf):
    tab, pts, valid = sf
    fpts, ids, nhits, got, _ = _kernel_gate(tab, pts, valid, "sub_bf16")
    want = dc._coarse_bf16_gate(fpts, ids, nhits, tab["seg_pack"],
                                tab["seg_sub"], 50.0)
    assert torch.equal(got.vote, want.vote)
    assert torch.equal(got.gate, want.gate)
    assert int(want.gate.sum()) < int(want.vote.sum())


@pytest.fixture(scope="module")
def rows(cuda):
    """Parallel streets 500 m apart (8 m segments every 10 m) and 80 m
    patches of points: the tensor-core gate's point-to-line bound culls
    about a fifth of the voted slices here (on sf it admits nearly all),
    so a wrong fragment layout would show as decisions that differ."""
    x = np.arange(0.0, 4000.0, 10.0)
    y = np.arange(0.0, 4000.0, 500.0)
    a = np.stack(np.meshgrid(x, y), -1).reshape(-1, 2).astype(np.float32)
    b = (a + np.float32([8.0, 0.0])).astype(np.float32)
    n = len(a)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           np.zeros(n, np.float32), np.full(n, 8.0, np.float32))
    tab = {k: torch.from_numpy(v).to(cuda) for k, v in
           zip(("seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
                "seg_coarse"), sp)}
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.0, 4000.0, (256, 1, 2))
    pts = (centres + rng.uniform(-30.0, 30.0, (256, 32, 2))).reshape(-1, 2)
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    return tab, pts, torch.ones(len(pts), dtype=torch.bool, device=cuda)


@pytest.mark.parametrize("tile", ["sf", "rows"])
@pytest.mark.parametrize("arm", ["mxu", "mxu_bf16"])
def test_tensor_core_gate_agrees_with_plain(request, tile, arm):
    tab, pts, valid = request.getfixturevalue(tile)
    fpts, ids, nhits, got, _ = _kernel_gate(tab, pts, valid, arm)
    want = dc._coarse_mxu_gate(fpts, ids, nhits, tab["seg_sub"],
                               tab["seg_feat"], 50.0,
                               "bf16" if arm == "mxu_bf16" else "off")
    assert torch.equal(got.vote, want.vote)
    differ = got.gate != want.gate
    near = (want.cmin - want.thr).abs() <= GATE_REL_TOL * want.thr
    assert not (differ & ~near).any()
    if tile == "rows":
        assert int(want.gate.sum()) < int(want.vote.sum())


@pytest.fixture(scope="module")
def padded(cuda):
    """The parallel streets cut to 3150 segments, so one slice holds 78
    real columns and 50 padding ones, and 512 points over that slice's
    box and 45 m around it: the bf16 filter's gate of the slice takes in
    the padding columns' clamped zero endpoints, as the plain gate does."""
    x = np.arange(0.0, 4000.0, 10.0)
    y = np.arange(0.0, 4000.0, 500.0)
    a = np.stack(np.meshgrid(x, y), -1).reshape(-1, 2).astype(np.float32)
    a = a[:3150]
    b = (a + np.float32([8.0, 0.0])).astype(np.float32)
    n = len(a)
    sp = dc.build_seg_pack(a, b, np.arange(n, dtype=np.int32),
                           np.zeros(n, np.float32), np.full(n, 8.0, np.float32))
    tab = {k: torch.from_numpy(v).to(cuda) for k, v in
           zip(("seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
                "seg_coarse"), sp)}
    quad = sp.sub.reshape(-1, 4)[n // dc._SUB]
    rng = np.random.default_rng(5)
    pts = rng.uniform(quad[:2] - 45.0, quad[2:] + 45.0, (512, 2))
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    return tab, pts, torch.ones(len(pts), dtype=torch.bool, device=cuda)


@pytest.mark.parametrize("tile", ["rows", "padded"])
def test_bf16_gate_culls_and_equals_plain(request, tile):
    """The bf16 filter's votes and gates equal the plain ones (tolerance
    0) where it culls (parallel streets) and on a slice of padding
    columns; its first-group passes are among its gates; its candidates
    equal _dense_plain."""
    tab, pts, valid = request.getfixturevalue(tile)
    fpts, ids, nhits, got, log = _kernel_gate(tab, pts, valid, "sub_bf16")
    want = dc._coarse_bf16_gate(fpts, ids, nhits, tab["seg_pack"],
                                tab["seg_sub"], 50.0)
    assert torch.equal(got.vote, want.vote)
    assert torch.equal(got.gate, want.gate)
    first = dc.decode_gate_log(log >> 8).vote
    assert not (first & ~got.gate).any()
    if tile == "rows":
        assert int(want.gate.sum()) < int(want.vote.sum())
    cand = dc.find_candidates_dense(
        pts, tuple(tab[k] for k in ("seg_pack", "seg_bbox", "seg_sub",
                                    "seg_feat", "seg_sweep", "seg_coarse")),
        50.0, 8, lowp="bf16")
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8)
    for g, r in zip((cand.edge, cand.offset, cand.dist), ref):
        assert torch.equal(g, r)


def test_sweep_wrapper_rejects_bad_input(cuda):
    pts = torch.zeros((256, 2), device=cuda)
    ids = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    nhits = torch.zeros(1, dtype=torch.int32, device=cuda)
    sub = torch.zeros((1, 16), device=cuda)
    sweep = torch.zeros((512, 8), device=cuda)
    coarse = torch.zeros((1, dc.CO_WORDS), dtype=torch.int32, device=cuda)
    log = torch.zeros((1, 8, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dc.sweep_topk(pts.cpu(), ids, nhits, sweep, None, None, 50.0, 8,
                      "block")
    with pytest.raises(ValueError, match=r"K in \(4, 6, 8, 12, 16\)"):
        dc.sweep_topk(pts, ids, nhits, sweep, None, None, 50.0, 5, "block")
    with pytest.raises(ValueError):      # the mxu arm without seg_coarse
        dc.sweep_topk(pts, ids, nhits, sweep, sub, None, 50.0, 8, "mxu")
    with pytest.raises(ValueError):      # the bf16 filter without seg_coarse
        dc.sweep_topk(pts, ids, nhits, sweep, sub, None, 50.0, 8,
                      "sub_bf16")
    with pytest.raises(ValueError):      # seg_coarse as f32 words
        dc.sweep_topk(pts, ids, nhits, sweep, sub, coarse.float(), 50.0, 8,
                      "mxu_bf16")
    with pytest.raises(ValueError):      # seg_coarse of the old width
        dc.sweep_topk(pts, ids, nhits, sweep, sub, coarse[:, :dc.CO_FLT],
                      50.0, 8, "sub_bf16")
    with pytest.raises(ValueError):      # the mxu arm without seg_sweep
        dc.sweep_topk(pts, ids, nhits, None, sub, coarse, 50.0, 8, "mxu")
    with pytest.raises(ValueError):      # an exact arm without seg_sweep
        dc.sweep_topk(pts, ids, nhits, None, sub, None, 50.0, 8, "sub")
    with pytest.raises(ValueError):      # seg_sweep laid out row by row
        dc.sweep_topk(pts, ids, nhits, sweep.reshape(8, 512), sub, None,
                      50.0, 8, "sub")
    with pytest.raises(ValueError):      # the block arm keeps no gate log
        dc.sweep_topk(pts, ids, nhits, sweep, None, None, 50.0, 8, "block",
                      gate_log=log)


@pytest.mark.parametrize("n", [1, 300, 2049])
def test_chunk_order_kernel_equals_plain(sf_tile, n):
    """The ring-fed call's chunk order kernel writes _chunk_order(nhits)
    (tolerance 0) over hit counts with many ties, and the counter it
    zeroes ends at nchunks + the grid (each CTA fails one take)."""
    from reporter_tpu_torch.kernels import build

    _, tab = sf_tile
    nblocks = tab["seg_bbox"].shape[0]
    gen = torch.Generator().manual_seed(n)
    nhits = torch.randint(0, nblocks + 1, (n,), generator=gen,
                          dtype=torch.int32).cuda()
    ids = torch.arange(nblocks, dtype=torch.int32).repeat(n, 1).cuda()
    pts = torch.zeros((n * dc._P, 2), device="cuda")
    order = torch.full((n + 1,), -7, dtype=torch.int32, device="cuda")
    out = [torch.empty((n * dc._P, 8), dtype=dt, device="cuda")
           for dt in (torch.int32, torch.float32, torch.float32)]
    build.launch_sweep_exact(pts, ids, nhits, order, tab["seg_sweep"], None,
                             None, dc.SWEEP_ARMS.index("block"), n, nblocks,
                             2500.0, 2500.0, 50.0, *out)
    torch.cuda.synchronize()
    assert torch.equal(order[:n], dc._chunk_order(nhits))
    sh = build.exact_shape(dc.SWEEP_ARMS.index("block"), 8)
    assert int(order[n]) == n + min(n, sh["ctas_per_sm"] * sh["sms"])


def _exact_points(ts, case):
    """Points for the exact arms' cases on the sf tile (f32 [n, 2]):
    ring — every chunk spread over the whole tile, so its hit list is
      longer than the kernel's ring of staged blocks;
    uneven — one chunk over the whole tile, every other one a 40 m patch;
    single — one partial chunk of a request's 120 fleet points;
    partial — 1000 fleet points, the last chunk partial;
    ties — every node (d = 0 junction ties) and points 48-52 m from
      segment midpoints (radius-boundary pairs)."""
    from reporter_tpu_torch.netgen.traces import synthesize_fleet

    rng = np.random.default_rng(11)
    lo, hi = ts.node_xy.min(0), ts.node_xy.max(0)
    if case == "ring":
        pts = rng.uniform(lo, hi, (1024, 2))
    elif case == "uneven":
        patches = rng.uniform(lo + 200, hi - 200, (15, 1, 2))
        pts = np.concatenate([
            rng.uniform(lo, hi, (256, 2)),
            (patches + rng.uniform(-20, 20, (15, 256, 2))).reshape(-1, 2)])
    elif case == "single":
        pts = synthesize_fleet(ts, 1, num_points=120, seed=4)[0].xy
    elif case == "partial":
        fleet = synthesize_fleet(ts, 10, num_points=100, seed=6)
        pts = np.concatenate([p.xy for p in fleet])
    else:
        mid = ((ts.seg_a + ts.seg_b) * 0.5)[::7]
        ang = rng.uniform(0, 2 * np.pi, len(mid))
        r = rng.uniform(48.0, 52.0, len(mid))[:, None]
        pts = np.concatenate([
            ts.node_xy, mid + np.stack([np.cos(ang), np.sin(ang)], 1) * r])
    return np.asarray(pts, np.float32)


@pytest.mark.parametrize("case", ["ring", "uneven", "single", "partial",
                                  "ties"])
@pytest.mark.parametrize("arm", ["block", "sub", "sub_bf16", "mxu",
                                 "mxu_bf16"])
def test_exact_arm_cases(sf_tile, arm, case):
    """The ring-fed arms of sweep_exact.cu, bit-equal to _dense_plain where
    their design could go wrong: hit lists longer than the ring, chunks of
    very different weight, one chunk, a partial last chunk, d = 0 ties and
    radius-boundary points. For the others than block, the kernel's votes
    equal the plain vote; sub's gate is its vote, the bf16 filter's equals
    _coarse_bf16_gate, the tensor-core arms' differs from _coarse_mxu_gate
    only within GATE_REL_TOL of the threshold; a gated arm's first-group
    passes are among its gates."""
    ts, tab = sf_tile
    pts = torch.from_numpy(_exact_points(ts, case)).cuda()
    n = len(pts)
    nchunks = -(-n // dc._P)
    fpts, fval = dc._fill_invalid(
        pts, torch.ones(n, dtype=torch.bool, device=pts.device), nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], 50.0,
                                     nchunks)
    nblocks = ids.shape[1]
    if case == "ring":
        assert int(nhits.min()) == nblocks > 4
    elif case == "uneven":
        assert int(nhits[0]) == nblocks and 2 * int(nhits[1:].max()) <= nblocks
    elif case == "single":
        assert nchunks == 1
    log = None if arm == "block" else torch.zeros(
        (nchunks, dc._P // 32, nblocks), dtype=torch.int32, device=pts.device)
    before = dc.SWEEP_LAUNCHES[arm, 8]
    got = dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                        tab["seg_coarse"], 50.0, 8, arm, gate_log=log)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8)
    torch.cuda.synchronize()
    assert dc.SWEEP_LAUNCHES[arm, 8] == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g[:n], r)
    if case == "ties":
        assert 2 * int((ref[2][:, 0] == 0).sum()) > len(ts.node_xy)
    if log is not None:
        kg = dc.decode_gate_log(log)
        want = dc._slice_votes(fpts, ids, nhits, tab["seg_sub"],
                               dc.cull_radius(50.0) ** 2)
        assert torch.equal(kg.vote, want)
        if arm == "sub":
            assert torch.equal(kg.gate, want)
        elif arm == "sub_bf16":
            pg = dc._coarse_bf16_gate(fpts, ids, nhits, tab["seg_pack"],
                                      tab["seg_sub"], 50.0)
            assert torch.equal(kg.gate, pg.gate)
        else:
            pg = dc._coarse_mxu_gate(fpts, ids, nhits, tab["seg_sub"],
                                     tab["seg_feat"], 50.0,
                                     "bf16" if arm == "mxu_bf16" else "off")
            near = (pg.cmin - pg.thr).abs() <= GATE_REL_TOL * pg.thr
            assert not ((kg.gate != pg.gate) & ~near).any()
        if arm != "sub":
            first = dc.decode_gate_log(log >> 8).vote
            assert not (first & ~kg.gate).any()
