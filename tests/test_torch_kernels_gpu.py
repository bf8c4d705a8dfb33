"""The CUDA sweep kernel (reporter_tpu_torch/kernels/sweep_exact.cu, its
five arms at each top-K width of SWEEP_KS and in the wide instances past
them), the batched Viterbi decode (kernels/viterbi.cu), the ranked-path
lattice's three kernels (kernels/lattice.cu) and the grid candidates
(kernels/grid.cu) against their plain PyTorch versions, on the card, the
host-to-card staging (device.host_to_device), and the native host half
of match_many there. The Viterbi: tolerance 0 in all five fields (the
same f32 arithmetic, one rounding per operation, the same first-argmin
ties); the lattice and the grid: tolerance 0 in every output.
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

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
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


@pytest.mark.parametrize("arm", dc.SWEEP_ARMS)
def test_sweep_squared_output_equals_plain(sf, arm):
    """squared=True (the segment-sharded merge's input): the kernel's
    dist holds d², equal to the plain version's (tolerance 0), and its
    square root (root_dist) the normal output."""
    tab, pts, valid = sf
    levers = {"block": dict(subcull=False), "sub": {},
              "sub_bf16": dict(lowp="bf16"), "mxu": dict(mxu=True),
              "mxu_bf16": dict(mxu=True, lowp="bf16")}[arm]
    seg = (tab["seg_pack"], tab["seg_bbox"], tab["seg_sub"],
           tab["seg_feat"], tab["seg_sweep"], tab["seg_coarse"])
    got = dc.find_candidates_dense(pts, seg, 50.0, 8, valid=valid,
                                   squared=True, **levers)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8, squared=True)
    for g, r in zip((got.edge, got.offset, got.dist), ref):
        assert torch.equal(g[valid], r[valid])
    normal = dc.find_candidates_dense(pts, seg, 50.0, 8, valid=valid,
                                      **levers)
    assert torch.equal(dc.root_dist(got.dist), normal.dist)


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
    """The set the sweep serves is K >= 1: below it sweep_topk raises
    naming the built widths; past max(SWEEP_KS) the wide instance runs at
    K itself."""
    tab, pts, _ = sf
    fpts = pts[:dc._P].contiguous()
    ids, nhits = dc._chunk_block_ids(
        fpts, torch.ones(dc._P, dtype=torch.bool, device=pts.device),
        tab["seg_bbox"], 50.0, 1)
    for k in (0, -1):
        with pytest.raises(ValueError, match="K in"):
            dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                          tab["seg_coarse"], 50.0, k, "sub")
    for k in (dc.SWEEP_KS[-1] + 1, 32):
        got = dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"],
                            tab["seg_sub"], tab["seg_coarse"], 50.0, k, "sub")
        assert all(g.shape == (dc._P, k) for g in got)


@pytest.mark.parametrize("k", (5, 7, 10))
@pytest.mark.parametrize("arm", dc.SWEEP_ARMS)
def test_sweep_between_the_built_widths(sf, arm, k):
    """A K between the built widths runs the next built instance K' and
    keeps its first K columns: bit-equal to _dense_plain at K, the
    launch counted under (arm, K')."""
    tab, pts, valid = sf
    n = len(pts)
    nchunks = -(-n // dc._P)
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], 50.0,
                                     nchunks)
    kk = dc.sweep_instance_k(k)
    before = dict(dc.SWEEP_LAUNCHES)
    got = dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                        tab["seg_coarse"], 50.0, k, arm)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, k)
    torch.cuda.synchronize()
    assert {key: v - before.get(key, 0)
            for key, v in dc.SWEEP_LAUNCHES.items()
            if v != before.get(key, 0)} == {(arm, kk): 1}
    for g, r in zip(got, ref):
        assert g.shape == (nchunks * dc._P, k) and g.is_contiguous()
        assert torch.equal(g[:n][valid], r[valid])


WIDE_RADIUS = 150.0     # sf: most points have more than 16 edges within it
EVICT_RADIUS = 400.0    # sf: lists of every K up to 64 fill and evict
NEVER_FULL_RADIUS = 50.0   # sf: no point has more than 16 edges within it
_WIDE_REF: dict = {}
_FLEET_REF: dict = {}
# per arm: K = 17 and 48 at 150 m; its largest shared-memory K and the next
# (the scratch instance's first) where lists evict and where none fills
_WIDE_CASES = [(arm, k, WIDE_RADIUS) for arm in dc.SWEEP_ARMS
               for k in (17, 48)] + [
    (arm, k, r) for arm in dc.SWEEP_ARMS
    for k in (dc.shared_max_k(arm), dc.shared_max_k(arm) + 1)
    for r in (EVICT_RADIUS, NEVER_FULL_RADIUS)]


def _wide_ref(pts, pack, k, radius=WIDE_RADIUS):
    if (k, radius) not in _WIDE_REF:
        _WIDE_REF[k, radius] = dc._dense_plain(pts, pack, radius, k)
    return _WIDE_REF[k, radius]


@pytest.mark.parametrize("arm,k,radius", _WIDE_CASES)
def test_wide_instance_equals_plain(sf, arm, k, radius):
    """K past SWEEP_KS runs a wide instance at K itself (its lists in
    shared memory up to the arm's shared_max_k, in a global scratch past
    it): bit-equal to _dense_plain on the valid points, at 150 m (lists
    past 16 fill and evict), at 400 m (every list fills and evicts) and at
    50 m (no list fills), the launch counted under launch_key(arm, K) and
    the launch shape's shared memory and ring depth list_plan's (two CTAs
    an SM where list_plan leaves room for them)."""
    from reporter_tpu_torch.kernels import build

    tab, pts, valid = sf
    n = len(pts)
    nchunks = -(-n // dc._P)
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], radius,
                                     nchunks)
    before = dict(dc.SWEEP_LAUNCHES)
    got = dc.sweep_topk(fpts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                        tab["seg_coarse"], radius, k, arm)
    torch.cuda.synchronize()
    assert {key: v - before.get(key, 0)
            for key, v in dc.SWEEP_LAUNCHES.items()
            if v != before.get(key, 0)} == {dc.launch_key(arm, k): 1}
    sh = build.exact_shape(dc.SWEEP_ARMS.index(arm), k)
    where, smem, depth = dc.list_plan(arm, k)
    assert (sh["smem_bytes"], sh["depth"]) == (smem, depth)
    assert sh["ctas_per_sm"] >= 1
    if where == "shared" \
            and 2 * (smem + dc.CTA_RESERVED_SMEM) <= dc.SMEM_PER_SM:
        assert sh["ctas_per_sm"] == 2
    ref = _wide_ref(pts, tab["seg_pack"], k, radius)
    filled = (ref[0][valid] >= 0).sum(1)
    if radius == NEVER_FULL_RADIUS:
        assert int(filled.max()) <= dc.SWEEP_KS[-1]
    elif radius == EVICT_RADIUS:
        assert int((filled == k).sum()) > len(filled) // 2
    else:
        assert int(filled.max()) > dc.SWEEP_KS[-1]
    for g, r in zip(got, ref):
        assert g.shape == (nchunks * dc._P, k)
        assert torch.equal(g[:n][valid], r[valid])


@pytest.mark.parametrize("arm", dc.SWEEP_ARMS)
def test_wide_instance_past_the_grid(sf_tile, sf_fleet, arm):
    """The wide instances on 512 chunks, more than their persistent grid
    (CTAs take second chunks: the list's reset at a new point), at K = 32,
    at the arm's largest shared-memory K and at the next (the scratch
    instance), bit-equal to _dense_plain on every point; squared=True
    too."""
    from reporter_tpu_torch.kernels import build

    _, tab = sf_tile
    pts = sf_fleet
    nchunks = len(pts) // dc._P
    ids, nhits = dc._chunk_block_ids(
        pts, torch.ones(len(pts), dtype=torch.bool, device=pts.device),
        tab["seg_bbox"], WIDE_RADIUS, nchunks)
    cap = dc.shared_max_k(arm)
    for k in (32, cap, cap + 1):
        if k not in _FLEET_REF:       # arms share their K: one plain each
            _FLEET_REF[k] = dc._dense_plain(pts, tab["seg_pack"],
                                            WIDE_RADIUS, k)
        ref = _FLEET_REF[k]
        sh = build.exact_shape(dc.SWEEP_ARMS.index(arm), k)
        assert nchunks > sh["ctas_per_sm"] * sh["sms"]
        got = dc.sweep_topk(pts, ids, nhits, tab["seg_sweep"],
                            tab["seg_sub"], tab["seg_coarse"], WIDE_RADIUS,
                            k, arm)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (arm, k)
        sq = dc.sweep_topk(pts, ids, nhits, tab["seg_sweep"], tab["seg_sub"],
                           tab["seg_coarse"], WIDE_RADIUS, k, arm,
                           squared=True)
        assert torch.equal(dc.root_dist(sq[2]), ref[2]), (arm, k)


def test_host_to_device_is_pinned_and_does_not_block(cuda):
    """The staging helper under sync-debug "error": no synchronizing call
    (a pageable copy makes one, which is why the port stages through
    pinned memory), and the caller may overwrite its array at once."""
    from reporter_tpu_torch.device import host_to_device

    x = np.arange(1 << 20, dtype=np.int64)
    want = x.copy()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = host_to_device(x, cuda)
        x[:] = -1
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.from_numpy(x).to(cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert t.device.type == "cuda" and t.dtype == torch.int64
    assert np.array_equal(t.cpu().numpy(), want)


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
        dc.sweep_topk(pts, ids, nhits, sweep, None, None, 50.0, 0, "block")
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


def test_speed_histogram_on_the_card_equals_numpy(cuda):
    """SpeedHistogram's i32 state lives on the card and every update is
    one index_add_; over several updates of random rows, with rows out of
    range and speeds below the first edge (they add nothing), the counts
    equal a numpy np.add.at of the same rows, and the state never left
    the card between updates."""
    from reporter_tpu_torch.streaming.histogram import SpeedHistogram

    rng = np.random.default_rng(5)
    edges = (0.0, 2.5, 5.0, 7.5, 10.0, 15.0, 20.0, 30.0, 40.0)
    rows_n = 5000
    h = SpeedHistogram(rows_n, edges, device=cuda)
    assert h._hist.device.type == "cuda" and h._hist.dtype == torch.int32
    want = np.zeros((rows_n, len(edges)), np.int64)
    for n in (1, 4096, 4097, 100_000, 37):
        rows = rng.integers(-50, rows_n + 50, n).astype(np.int32)
        speeds = rng.uniform(-5.0, 60.0, n)
        h.update(rows, speeds)
        bins = np.searchsorted(edges, speeds, side="right") - 1
        ok = (rows >= 0) & (rows < rows_n) & (bins >= 0)
        np.add.at(want, (rows[ok], bins[ok]), 1)
        assert h._hist.device.type == "cuda"
    np.testing.assert_array_equal(h.snapshot(), want)
    np.testing.assert_array_equal(h.nonzero_rows(),
                                  np.nonzero(want.sum(axis=1))[0])
    h.load(want.astype(np.int32))
    h.update(np.array([0], np.int32), np.array([1.0]))
    want[0, 0] += 1
    np.testing.assert_array_equal(h.snapshot(), want)


def test_fixed_grid_counts_on_the_card_equal_reference(cuda):
    """Backfill's FixedGridCounts keeps its i32 grid on the card, one
    index_add_ per update; over updates of every length around the JAX
    package's 4096-index update shape, with indices below 0 and past the
    end (they add nothing), the snapshot equals reference_counts of the
    whole stream (tolerance 0), and a load round trip keeps it."""
    from reporter_tpu_torch.ops.aggregate import (FixedGridCounts,
                                                  reference_counts)

    rng = np.random.default_rng(9)
    size = 24 * 12 * 700              # a speed x time-of-day grid
    g = FixedGridCounts(size, device=cuda)
    assert g._parts[0].device.type == "cuda" \
        and g._parts[0].dtype == torch.int32
    stream = []
    for n in (0, 1, 4095, 4096, 4097, 3 * 4096 + 17, 250_000):
        idx = rng.integers(-7, size + 7, n)
        assert g.add(idx) == int(((idx >= 0) & (idx < size)).sum())
        stream.append(idx)
        assert g._parts[0].device.type == "cuda"
    want = reference_counts(size, np.concatenate(stream))
    np.testing.assert_array_equal(g.snapshot(), want)
    g2 = FixedGridCounts(size, device=cuda)
    g2.load(want)
    g2.add(np.array([5, 5]))
    want[5] += 2
    np.testing.assert_array_equal(g2.snapshot(), want)


@pytest.fixture(scope="module")
def tiny_pair(cuda):
    """The tiny tile (the ranked-path tests' parameters) as a grid and a
    dense matcher on the card and on the CPU."""
    from reporter_tpu_torch.config import CompilerParams, MatcherParams
    from reporter_tpu_torch.matcher.api import SegmentMatcher

    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0,
                                        osmlr_max_length=250.0))
    out = {}
    for backend in ("grid", "dense"):
        p = MatcherParams(candidate_backend=backend, sweep_autotune=False)
        out[backend] = (SegmentMatcher(ts, p, device=cuda),
                        SegmentMatcher(ts, p, device="cpu"))
    return ts, out


def _no_plain_loops(monkeypatch):
    """Make the plain (Python-loop) versions of the lattice and grid
    kernels, and the transition blocks the lattice's plain forward reads,
    raise if called: a card path that ran one fails."""
    from reporter_tpu_torch.ops import candidates as cand
    from reporter_tpu_torch.ops import hmm

    def refuse(name):
        def fn(*a, **kw):
            raise AssertionError(f"the plain {name} ran on the card path")
        return fn

    for mod, name in ((hmm, "_keep_mask_batched"),
                      (hmm, "_lattice_prep"),
                      (hmm, "_forward_list_plain"),
                      (hmm, "_backtrack_plain"),
                      (cand, "_find_candidates_plain"),
                      (cand, "_topk_distinct_edges")):
        monkeypatch.setattr(mod, name, refuse(name))


def test_grid_gather_on_the_card_equals_cpu(tiny_pair, cuda, monkeypatch):
    """The grid candidate backend on the card (one launch of
    kernels/grid.cu, no Python loop) against the CPU port: tolerance 0,
    and no sweep launch."""
    from reporter_tpu_torch.ops import candidates as cand

    ts, pair = tiny_pair
    card, cpu = pair["grid"]
    rng = np.random.default_rng(2)
    pts = np.concatenate([
        np.concatenate([p.xy for p in synthesize_fleet(ts, 16, seed=3)]),
        ts.node_xy, rng.uniform(ts.node_xy.min(0) - 80,
                                ts.node_xy.max(0) + 80, (2000, 2))])
    pts = torch.from_numpy(pts.astype(np.float32))
    want = cand.find_candidates(pts, cpu.tables, ts.meta, 50.0, 8)
    before = dict(dc.SWEEP_LAUNCHES)
    grid_before = cand.GRID_LAUNCHES.get(8, 0)
    with monkeypatch.context() as mp:
        _no_plain_loops(mp)
        got = cand.find_candidates(pts.to(cuda), card.tables, ts.meta, 50.0,
                                   8)
        for g, w in zip(got, want):
            assert g.cpu().numpy().tobytes() == w.numpy().tobytes()
    assert dict(dc.SWEEP_LAUNCHES) == before
    assert cand.GRID_LAUNCHES[8] == grid_before + 1


@pytest.mark.parametrize("backend", ["dense", "grid"])
def test_match_topk_on_the_card_equals_cpu(tiny_pair, backend, monkeypatch):
    """match_topk on the card (the sweep instance or the grid kernel, then
    the lattice's three kernels, one launch each a call, no Python loop)
    against the CPU port, both forms: the same ranked paths and scores
    (tolerance 0)."""
    from reporter_tpu_torch.matcher.api import Trace
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.ops import candidates as cand
    from reporter_tpu_torch.ops import hmm

    ts, pair = tiny_pair
    card, cpu = pair[backend]
    for seed in (5, 13):
        pr = synthesize_probe(ts, seed=seed, num_points=30, speed_mps=12.0,
                              gps_sigma=3.0)
        tr = Trace(uuid="u", xy=pr.xy.astype(np.float32), times=pr.times)
        for exact in (False, True):
            want = cpu.match_topk(tr, exact=exact)
            before = dict(hmm.LATTICE_LAUNCHES)
            grid_before = sum(cand.GRID_LAUNCHES.values())
            with monkeypatch.context() as mp:
                _no_plain_loops(mp)
                got = card.match_topk(tr, exact=exact)
            for key in ("keep", "forward", "backtrack"):
                assert hmm.LATTICE_LAUNCHES[key] == before.get(key, 0) + 1
            assert sum(cand.GRID_LAUNCHES.values()) == grid_before + (
                backend == "grid")
            assert len(got) == len(want) >= 2
            for (gs, gp), (ws, wp) in zip(got, want):
                assert gs == ws
                assert [(p.edge, p.offset) for p in gp] == \
                    [(p.edge, p.offset) for p in wp]


def _fleet_metros(n=3):
    from reporter_tpu_torch.config import CompilerParams

    out = []
    for i in range(n):
        net = generate_city("tiny", nx=8, ny=8, seed=60 + i,
                            center=(-125.0 + 0.7 * i, 38.0))
        net.name = f"fleet{i:02d}"
        out.append(compile_network(net, CompilerParams(reach_radius=500.0)))
    return out


def test_fleet_promotion_is_a_pinned_copy(cuda):
    """A promotion on the card places the cold tier's pinned tensors:
    every cold-tier table is page-locked, every placed table lies on the
    card with the cold tier's bytes, and the records through evict →
    promote equal a dedicated matcher's on the card."""
    from reporter_tpu_torch.config import Config, MatcherParams
    from reporter_tpu_torch.fleet import FleetConfig, FleetResidency
    from reporter_tpu_torch.matcher.api import SegmentMatcher, Trace
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.tiles.tileset import HOST_KEYS, staged_nbytes

    metros = _fleet_metros()
    cfg = Config(matcher=MatcherParams(sweep_autotune=False))
    sizes = [staged_nbytes(t.host_tables("dense")) for t in metros]
    fr = FleetResidency(metros, cfg, FleetConfig(
        max_resident_bytes=sizes[0] + sizes[1] // 2, evict_watermark=1.0))
    ts = metros[0]
    traces = [Trace.from_json(synthesize_probe(
        ts, seed=s, num_points=60, gps_sigma=3.0).to_report_json(), ts)
        for s in (5, 6, 7)]
    want = [[r.to_json() for r in x] for x in SegmentMatcher(
        ts, cfg, device="cuda").match_many(traces)]
    for _ in range(2):                  # promote, evict, promote again
        with fr.lease(ts.name) as m:
            got = [[r.to_json() for r in x] for x in m.match_many(traces)]
            assert got == want
            host = fr._metros[ts.name].host
            for k, v in m.tables.items():
                assert v.is_cuda and host[k].is_pinned(), k
                assert v.cpu().numpy().tobytes() == \
                    host[k].numpy().tobytes(), k
            assert set(host) - set(m.tables) == set(HOST_KEYS)
            assert m.table_bytes == sizes[0]
        fr.promote(metros[1].name)      # evicts it
        assert not m.tables_staged
    assert fr.occupancy()["metros"][ts.name]["promotions"] == 2


def test_fleet_demotion_frees_its_staged_bytes(cuda):
    """Demotion returns the metro's blocks to the caching allocator:
    memory_allocated falls by its staged bytes rounded up to 512-byte
    blocks, one per table; promotion raises it by as much."""
    from reporter_tpu_torch.config import Config, MatcherParams
    from reporter_tpu_torch.fleet import FleetResidency

    metros = _fleet_metros(2)
    fr = FleetResidency(metros, Config(
        matcher=MatcherParams(sweep_autotune=False)))
    fr.promote(metros[1].name)
    for name in (metros[0].name, metros[0].name):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        fr.promote(name)
        torch.cuda.synchronize()
        up = torch.cuda.memory_allocated() - before
        m = fr.matcher(name)
        staged, n = m.table_bytes, len(m.tables)
        fr.demote(name)
        torch.cuda.synchronize()
        down = up + before - torch.cuda.memory_allocated()
        assert staged <= up < staged + 512 * n, (up, staged)
        assert down == up


# ---------------------------------------------------------------------------
# multi-GPU: every CUDA call on the device of its tensors, the mesh's wire


@pytest.mark.parametrize("i", range(8))
def test_sweep_on_each_card_with_another_card_current(sf_tile, cuda, i):
    """The sweep on cuda:i, bit-equal to _dense_plain there; where there
    is more than one card, with a different card current (the launch and
    its shape query run under the tensors' device guard, so the library
    reads cuda:i's occupancy and launches there)."""
    n = torch.cuda.device_count()
    if i >= n:
        pytest.skip(f"this host has {n} card(s)")
    ts, _ = sf_tile
    dev = torch.device("cuda", i)
    tab = tables_from_numpy(ts.arrays(), dev)
    fleet = np.concatenate([p.xy for p in synthesize_fleet(ts, 16, seed=5)])
    pts = torch.from_numpy(fleet.astype(np.float32)).to(dev)
    other = (i + 1) % n
    from reporter_tpu_torch.kernels import build

    with torch.cuda.device(i):
        shape_here = build.exact_shape(1, 8)
    with torch.cuda.device(other):
        assert build.exact_shape(1, 8, dev) == shape_here
        got = dc.find_candidates_dense(
            pts, tuple(tab[k] for k in ("seg_pack", "seg_bbox", "seg_sub",
                                        "seg_feat", "seg_sweep",
                                        "seg_coarse")), 50.0, 8)
        assert torch.cuda.current_device() == other
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8)
    torch.cuda.synchronize(dev)
    assert got.edge.device == dev
    for g, r in zip((got.edge, got.offset, got.dist), ref):
        assert torch.equal(g, r)


def test_dp_wire_matcher_over_one_card_equals_the_single_wire(sf_tile, cuda):
    """A DpWireMatcher over ["cuda:0"] * 4: every shard launches the
    sweep, and the harvested wire (a row count not a multiple of 4) is
    byte-equal to the single-device wire entry's."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.matcher.native_prepare import prepare_slice
    from reporter_tpu_torch.ops import match as match_ops
    from reporter_tpu_torch.parallel import DpWireMatcher, make_mesh

    ts, tab = sf_tile
    fleet = synthesize_fleet(ts, 37, num_points=100, seed=8)
    mode, p32, lens, origins, payload = prepare_slice(
        [p.xy.astype(np.float32) for p in fleet], 128)
    params = MatcherParams(sweep_autotune=False)
    spec = match_ops.wire_spec(ts.num_edges, float(ts.edge_len.max()))
    w = DpWireMatcher(make_mesh(dp=4, devices=["cuda:0"] * 4), ts, params,
                      spec)
    before = dc.SWEEP_LAUNCHES["sub", 8]
    if mode == 2:
        got = w.q8(payload, origins, lens, None)
        want = match_ops.wire_from_q8(
            *(torch.from_numpy(x).to(cuda) for x in (payload, origins,
                                                     lens)),
            tab, params, None, spec, ts.meta)
    else:
        got = w.q16(payload, origins, lens, None)
        want = match_ops.wire_from_q16(
            *(torch.from_numpy(x).to(cuda) for x in (payload, origins,
                                                     lens)),
            tab, params, None, spec, ts.meta)
    assert dc.SWEEP_LAUNCHES["sub", 8] == before + 5
    assert got.cpu().numpy()[:37].tobytes() == want.cpu().numpy().tobytes()


def test_device_contract_under_sync_debug_on_the_card(cuda):
    """The device contract's matrix on the card, each case under
    set_sync_debug_mode("error"): no unwaived finding (the CPU-only
    waiver of the plain square root does not apply here); a seeded
    .item() is caught there both by the recorder and by sync debug."""
    from reporter_tpu_torch.analysis import device_contract as dcon

    stats = {}
    found = dcon.run_device_contract(cuda, stats=stats)
    assert stats["cases"] == len(dcon.audit_cases()) + 3 + 5 + 2
    assert stats["staging_cases"] == 5
    assert not [f for f in found if not f.waived], \
        "\n".join(str(f) for f in found if not f.waived)
    x = torch.ones(8, device=cuda)
    _, seeded, _ = dcon.audit(lambda: x.sum().item(), "seed", cuda,
                              ("tests/synthetic.py", 1))
    assert {f.rule for f in seeded} == {"device-sync"}
    assert any("raised" in f.message for f in seeded)
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------------
# the batched Viterbi decode (kernels/viterbi.cu) against its plain version

_VIT_FIELDS = ("choice", "edge", "offset", "chain_start", "matched")


@pytest.fixture(scope="module")
def vit_fleet(sf_tile, cuda):
    """The sf fleet as a Viterbi batch: 1024 traces of 120 points, with a
    mix of chain breaks (a 900 m jump in every 7th trace) and padding (the
    tail of every 5th trace invalid, at its first point)."""
    ts, _ = sf_tile
    fleet = synthesize_fleet(ts, 1024, num_points=120, seed=6)
    pts = np.stack([p.xy for p in fleet]).astype(np.float32)
    valid = np.ones(pts.shape[:2], bool)
    pts[::7, 60:] += np.float32(900.0)
    valid[::5, 90:] = False
    pts[::5, 90:] = pts[::5, :1]
    return (torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda))


_VIT_CANDS = {}


# a search radius at which sf's lists run past 64 edges (up to some 90;
# at 150 m up to some 48)
LONG_LIST_RADIUS = 250.0


def _vit_cands(sf_tile, vit_fleet, k, radius=None):
    """The fleet's candidates at width k: at 50 m up to K = 8, at 150 m
    past it (where sf's lists fill past K = 16), or at ``radius``."""
    radius = radius or (50.0 if k <= 8 else 150.0)
    if (k, radius) not in _VIT_CANDS:
        _, tab = sf_tile
        pts, valid = vit_fleet
        b, t = valid.shape
        c = dc.find_candidates_dense(
            pts.reshape(-1, 2), tuple(tab[n] for n in (
                "seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
                "seg_coarse")), radius, k, valid=valid.reshape(-1))
        _VIT_CANDS[k, radius] = dc.CandidateSet(*(x.reshape(b, t, k)
                                                  for x in c))
    return _VIT_CANDS[k, radius]


def _vit_args(tab, interp, breakage=150.0):
    from reporter_tpu_torch.config import MatcherParams

    p = MatcherParams()
    return (tab, p.sigma_z, p.beta, p.max_route_distance_factor, breakage,
            p.backward_slack, interp)


def _vit_equal(cands, pts, valid, tab, k):
    """The kernel against the plain version on the card, interpolation on
    and off: every field bit-equal, one launch counted under K a call."""
    from reporter_tpu_torch.ops import hmm

    for interp in (10.0, 0.0):
        args = (cands, pts, valid, *_vit_args(tab, interp))
        before = hmm.VITERBI_LAUNCHES.get(k, 0)
        got = hmm.viterbi_decode_batched(*args)
        assert hmm.VITERBI_LAUNCHES[k] == before + 1
        want = hmm._viterbi_plain(*args)
        torch.cuda.synchronize()
        for f in _VIT_FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert torch.equal(g, w), (f, int((g != w).sum()))
    return got


@pytest.mark.parametrize("t", [1, 120])
@pytest.mark.parametrize("b", [1, 3, 1024])
@pytest.mark.parametrize("k", [1, 8, 16, 33, 64])
def test_viterbi_kernel_equals_plain(sf_tile, vit_fleet, k, b, t):
    """Every field bit-equal to the plain version on the card (B = 3: a
    CTA of two traces only partly filled up to K = 32)."""
    _, tab = sf_tile
    pts, valid = vit_fleet
    cands = dc.CandidateSet(*(x[:b, :t] for x in _vit_cands(sf_tile,
                                                            vit_fleet, k)))
    got = _vit_equal(cands, pts[:b, :t], valid[:b, :t], tab, k)
    if b == 1024 and t == 120:
        assert got.matched.any() and int(got.chain_start.sum()) > b


_VIT_LONG = {}


@pytest.mark.parametrize("b", [1, 3, 1024])
@pytest.mark.parametrize("k", [8, 32, 64])
def test_viterbi_kernel_equals_plain_on_1024_points(sf_tile, vit_fleet, k,
                                                    b):
    """T = 1024, where the plan keeps the levels in the global scratch at
    K = 32 and 64 (staged back block by block for the backtrack) and in
    shared memory at K = 8: each row nine fleet traces end to end (a
    jump, so a chain break, every 120 points), cut to 1024 points."""
    from reporter_tpu_torch.ops import hmm

    ts, tab = sf_tile
    assert hmm.viterbi_plan(b, 1024, k)["levels"] \
        == ("shared" if k == 8 else "global")
    if k not in _VIT_LONG:
        pts, valid = vit_fleet
        n = pts.shape[0]
        idx = (torch.arange(n)[:, None] + torch.arange(9)[None, :]) % n
        lp = pts[idx.to(pts.device)].reshape(n, -1, 2)[:, :1024]
        lv = valid[idx.to(valid.device)].reshape(n, -1)[:, :1024]
        lp, lv = lp.contiguous(), lv.contiguous()
        c = dc.find_candidates_dense(
            lp.reshape(-1, 2), tuple(tab[m] for m in (
                "seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
                "seg_coarse")), 50.0 if k <= 8 else 150.0, k,
            valid=lv.reshape(-1))
        _VIT_LONG[k] = (dc.CandidateSet(*(x.reshape(n, 1024, k) for x in c)),
                        lp, lv)
    cands, lp, lv = _VIT_LONG[k]
    cands = dc.CandidateSet(*(x[:b] for x in cands))
    got = _vit_equal(cands, lp[:b], lv[:b], tab, k)
    assert got.matched.any() and int(got.chain_start.sum()) > b


def _numpy_case(ts, mid, k, seed, b=6, t=40):
    """tests/test_torch_viterbi_kernel.py's _case, made with the port's
    generate_city / synthesize_fleet and numpy: the K nearest edges by
    midpoint, offsets within each edge, distances rounded to 0.5 m (equal
    emissions), slot 1 repeating slot 0 on a third of the points (exact
    cost ties), holes (-1, invalid), invalid slots, -1 yet valid slots, a
    padded tail, a trace with no valid point, a 900 m jump (a chain break)
    and points without a candidate."""
    rng = np.random.default_rng(seed)
    fleet = synthesize_fleet(ts, b, num_points=t, seed=seed)
    pts = np.stack([p.xy for p in fleet]).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 25:] = False
    pts[1, 25:] = pts[1, 0]
    valid[4] = False
    pts[3, 20:] += np.float32(900.0)
    d2 = ((pts[:, :, None, :] - mid[None, None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    edge = order.astype(np.int32)
    lens = ts.edge_len[edge].astype(np.float32)
    offset = (rng.random(edge.shape, np.float32) * lens).astype(np.float32)
    dist = np.round(np.sqrt(np.take_along_axis(d2, order, -1)) * 2) / 2
    dist = dist.astype(np.float32)
    cvalid = np.ones(edge.shape, bool)
    if k > 1:
        rep = rng.random((b, t)) < 0.33
        for a in (edge, offset, dist):
            a[..., 1] = np.where(rep, a[..., 0], a[..., 1])
        hole = rng.random(edge.shape) < 0.15
        hole[..., 0] = False
        edge[hole] = -1
        dist[hole] = np.float32(dc.BIG)
        cvalid[hole] = False
        cvalid[rng.random(edge.shape) < 0.1] = False
        edge[(rng.random(edge.shape) < 0.03) & cvalid] = -1
    cvalid[2, 10:14] = False
    return pts, valid, (edge, offset, dist, cvalid)


@pytest.mark.parametrize("k", [1, 8, 16, 33, 64])
def test_viterbi_kernel_equals_plain_on_the_numpy_case(cuda, k):
    """The CPU tests' lattice (ties, holes, -1 yet valid, breaks, padding)
    on the tiny tile, the kernel against the plain version on the card."""
    from reporter_tpu_torch.config import CompilerParams

    ts = compile_network(generate_city("tiny"),
                         CompilerParams(reach_radius=500.0,
                                        osmlr_max_length=200.0))
    tab = tables_from_numpy(ts.arrays(), cuda)
    mid = (0.5 * (ts.node_xy[ts.edge_src] + ts.node_xy[ts.edge_dst])
           ).astype(np.float32)
    pts, valid, cands = _numpy_case(ts, mid, k, seed=k)
    c = dc.CandidateSet(*(torch.from_numpy(x).to(cuda) for x in cands))
    got = _vit_equal(c, torch.from_numpy(pts).to(cuda),
                     torch.from_numpy(valid).to(cuda), tab, k)
    m = got.matched.cpu().numpy()
    assert m[0].any() and not m[4].any() and not m[1, 25:].any()
    assert got.chain_start.cpu().numpy()[3, 20]


@pytest.mark.parametrize("k", [8, 64])
def test_viterbi_kernel_takes_any_length(sf_tile, vit_fleet, k):
    """T past the card's shared memory (T bytes a trace would not fit a
    CTA): the levels and the choices global, so the kernel launches at
    any T. Each row is one fleet trace that ends over twice the breakage
    distance from where it starts, repeated end to end: every repeat
    starts a chain, so the decode is the plain version's of the trace,
    repeated (that premise checked first on four repeats)."""
    from reporter_tpu_torch.ops import hmm

    _, tab = sf_tile
    pts, valid = vit_fleet
    cands = _vit_cands(sf_tile, vit_fleet, k)
    breakage = _vit_args(tab, 0.0)[4]
    span = (pts[:, -1] - pts[:, 0]).norm(dim=-1)
    rows = torch.nonzero(valid.all(1) & (span > 2 * breakage))[:3, 0]
    assert len(rows) == 3
    n = pts.shape[1]
    t = -(-hmm.VITERBI_SMEM_MAX // n) * n       # repeats of the trace
    plan = hmm.viterbi_plan(3, t, k)
    assert plan["levels"] == "global"
    assert plan["traces_per_cta"] * t > hmm.VITERBI_SMEM_MAX

    def repeat(r):
        c = dc.CandidateSet(*(x[rows].repeat(1, r, 1).contiguous()
                              for x in cands))
        return (c, pts[rows].repeat(1, r, 1).contiguous(),
                valid[rows].repeat(1, r).contiguous())

    for interp in (10.0, 0.0):
        one = hmm._viterbi_plain(*repeat(1), *_vit_args(tab, interp))
        four = hmm._viterbi_plain(*repeat(4), *_vit_args(tab, interp))
        got = hmm.viterbi_decode_batched(*repeat(t // n),
                                         *_vit_args(tab, interp))
        torch.cuda.synchronize()
        for f in _VIT_FIELDS:
            w = getattr(one, f)
            assert torch.equal(getattr(four, f), w.repeat(1, 4)), f
            g = getattr(got, f)
            assert g.shape == (3, t)
            assert torch.equal(g, w.repeat(1, t // n)), \
                (f, int((g != w.repeat(1, t // n)).sum()))
        assert got.matched.any()


def _layout_args(cuda, t, k):
    """Zero-filled inputs at [1, t, k] and a one-row reach table on the
    card: enough for the kernel's plan checks and a launch."""
    z = dict(device=cuda)
    ce = torch.full((1, t, k), -1, dtype=torch.int32, **z)
    co, cd = torch.zeros((1, t, k), **z), torch.zeros((1, t, k), **z)
    cv = torch.zeros((1, t, k), dtype=torch.bool, **z)
    pts = torch.zeros((1, t, 2), **z)
    vp = torch.ones((1, t), dtype=torch.bool, **z)
    tab = (torch.ones(1, **z), torch.zeros(1, dtype=torch.int32, **z),
           torch.full((1, 128), -1, dtype=torch.int32, **z),
           torch.zeros((1, 128), **z))
    outs = [torch.empty((1, t), dtype=d, **z) for d in (
        torch.int32, torch.int32, torch.float32, torch.bool, torch.bool)]
    return (ce, co, cd, cv, pts, vp, *tab), outs


@pytest.mark.parametrize("t", [1, 16, 120, 128, 1024])
def test_viterbi_plan_smem_equals_the_kernels_layout(cuda, t):
    """hmm.viterbi_plan's shared bytes are the kernel's own layout at
    every K, in both places of the levels: the launch takes the plan's
    figure and refuses it 16 bytes off (the C entry checks the figure
    against its layout); a layout past the card's 227 KB is refused."""
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.ops import hmm

    for k in range(1, hmm.VITERBI_MAX_K + 1):
        ins, outs = _layout_args(cuda, t, k)
        plan = hmm.viterbi_plan(1, t, k)
        for levels in ("shared", "global"):
            here = levels == "shared"
            pl = {**plan, "levels": levels,
                  "smem_bytes": plan["traces_per_cta"]
                  * hmm.viterbi_smem_bytes(t, k, plan["chunk"], here)}
            scratch = None if here else torch.empty(
                t * (k + 2), dtype=torch.uint8, device=cuda)

            def launch(nbytes):
                build.launch_viterbi(
                    *ins, {**pl, "smem_bytes": nbytes}, 2.0 * 4.07 ** 2,
                    3.0, 5.0, 2000.0, 10.0, True, 10.0, scratch, *outs)

            if pl["smem_bytes"] <= hmm.VITERBI_SMEM_MAX:
                launch(pl["smem_bytes"])
            else:
                with pytest.raises(RuntimeError, match="error -1"):
                    launch(pl["smem_bytes"])
            for off in (-16, 16):
                with pytest.raises(RuntimeError, match="error -1"):
                    launch(pl["smem_bytes"] + off)
        torch.cuda.synchronize()
        assert not outs[4].any(), (k, t)      # nothing to match


def test_viterbi_kernel_refuses_a_k_past_its_ceiling(sf_tile, vit_fleet):
    from reporter_tpu_torch.ops import hmm

    _, tab = sf_tile
    pts, valid = vit_fleet
    k = 3985       # the first K whose candidate rows outgrow a CTA
    c = dc.CandidateSet(*(x[:2, :4, :1].expand(2, 4, k).contiguous()
                          for x in _vit_cands(sf_tile, vit_fleet, 1)))
    with pytest.raises(ValueError, match=f"K={k} .*shared memory"):
        hmm.viterbi_decode_batched(c, pts[:2, :4], valid[:2, :4],
                                   *_vit_args(tab, 10.0))


def _wide_plan_ran(b, t, k):
    """The wide kernel's plan at (B, T, K), asserted: instance 1 to K =
    254, 2 from 255; its chunk and pass budget."""
    from reporter_tpu_torch.ops import hmm

    plan = hmm.viterbi_plan(b, t, k)
    assert plan["kernel"] == "viterbi_decode_wide_kernel"
    assert plan["instance"] == (1 if k <= 254 else 2)
    assert 1 <= plan["chunk"] <= min(32, t)
    assert plan["pairs"] == hmm.VITERBI_WIDE_PAIRS
    return plan


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("k", [65, 96, 128, 254, 255, 256])
def test_viterbi_wide_instances_equal_plain(sf_tile, vit_fleet, k, b):
    """Past K = 64 the wide kernel (one trace a CTA, chunks sized by their
    rows, the looked-up pairs in passes): every field bit-equal to the
    plain version on the card at T = 120, where sf's lists at
    LONG_LIST_RADIUS run past 64 edges (a chunk's pairs past one pass)."""
    _, tab = sf_tile
    pts, valid = vit_fleet
    plan = _wide_plan_ran(b, 120, k)
    cands = dc.CandidateSet(*(x[:b] for x in _vit_cands(
        sf_tile, vit_fleet, k, LONG_LIST_RADIUS)))
    if b == 64:
        assert bool((cands.valid.sum(-1) > 64).any())
    got = _vit_equal(cands, pts[:b], valid[:b], tab, k)
    assert got.matched.any()
    assert plan["levels"] == ("shared" if k <= 96 else "global")


@pytest.mark.parametrize("pairs", [32, 37, 500])
@pytest.mark.parametrize("k", [96, 255])
def test_viterbi_wide_passes_split_steps(sf_tile, vit_fleet, monkeypatch,
                                         k, pairs):
    """A small pass budget (a step's pairs straddle passes, each column's
    first minimum carried over): still bit-equal to the plain version."""
    from reporter_tpu_torch.ops import hmm

    _, tab = sf_tile
    pts, valid = vit_fleet
    b = 16
    plan_of = hmm.viterbi_plan

    def small(B, T, K):
        plan = plan_of(B, T, K)
        here = plan["levels"] == "shared"
        return {**plan, "pairs": pairs, "smem_bytes":
                hmm.viterbi_wide_smem_bytes(T, K, plan["chunk"], pairs,
                                            here)}

    monkeypatch.setattr(hmm, "viterbi_plan", small)
    cands = dc.CandidateSet(*(x[:b] for x in _vit_cands(
        sf_tile, vit_fleet, k, LONG_LIST_RADIUS)))
    got = _vit_equal(cands, pts[:b], valid[:b], tab, k)
    assert got.matched.any()


@pytest.mark.parametrize("k", [96, 128, 256])
def test_viterbi_wide_instance_on_1024_points(sf_tile, vit_fleet, k):
    """K = 96, 128 and 256 at T = 1024 (the levels in the global scratch,
    staged back for the backtrack), three traces end to end."""
    _, tab = sf_tile
    pts, valid = vit_fleet
    b = 3
    plan = _wide_plan_ran(b, 1024, k)
    assert plan["levels"] == "global"
    idx = (torch.arange(b)[:, None] + torch.arange(9)[None, :]) \
        % pts.shape[0]
    lp = pts[idx.to(pts.device)].reshape(b, -1, 2)[:, :1024].contiguous()
    lv = valid[idx.to(valid.device)].reshape(b, -1)[:, :1024].contiguous()
    c = dc.find_candidates_dense(
        lp.reshape(-1, 2), tuple(tab[m] for m in (
            "seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
            "seg_coarse")), LONG_LIST_RADIUS, k, valid=lv.reshape(-1))
    cands = dc.CandidateSet(*(x.reshape(b, 1024, k) for x in c))
    got = _vit_equal(cands, lp, lv, tab, k)
    assert got.matched.any()


@pytest.mark.parametrize("k", [65, 96, 128, 254, 255, 300])
def test_viterbi_wide_instances_on_the_numpy_case(sf_tile, k):
    """The numpy lattice (ties, holes, -1 yet valid, breaks, padding) on
    sf's K nearest edges by midpoint, past K = 64: instance 1 (u8
    backpointers) to K = 254, instance 2 (u16) from 255; the kernel
    against the plain version on the card."""
    ts, tab = sf_tile
    mid = (0.5 * (ts.node_xy[ts.edge_src] + ts.node_xy[ts.edge_dst])
           ).astype(np.float32)
    pts, valid, cands = _numpy_case(ts, mid, k, seed=k, t=24)
    _wide_plan_ran(6, 24, k)
    dev = tab["edge_len"].device
    c = dc.CandidateSet(*(torch.from_numpy(x).to(dev) for x in cands))
    got = _vit_equal(c, torch.from_numpy(pts).to(dev),
                     torch.from_numpy(valid).to(dev), tab, k)
    assert got.matched.cpu().numpy()[0].any()


def test_viterbi_wide_plan_smem_equals_the_kernels_layout(cuda):
    """Past K = 64 the plan's shared bytes are the wide kernel's layout in
    both places of the levels and at several pass budgets (a launch of
    zero-filled inputs takes them and refuses them 16 bytes off); a plan
    of the wrong instance, or with no pass budget, is refused."""
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.ops import hmm

    t = 16
    for k in (65, 96, 128, 234, 255, 300):
        ins, outs = _layout_args(cuda, t, k)
        plan = hmm.viterbi_plan(1, t, k)
        for levels in ("shared", "global"):
            for pairs in (1, 33, plan["pairs"]):
                here = levels == "shared"
                nbytes = hmm.viterbi_wide_smem_bytes(t, k, plan["chunk"],
                                                     pairs, here)
                if nbytes > hmm.VITERBI_SMEM_MAX:
                    continue
                bpb = 1 if k < 255 else 2
                size = 0 if here else t * (4 + bpb * k)
                scratch = None if not size else torch.empty(
                    size, dtype=torch.uint8, device=cuda)
                pl = {**plan, "levels": levels, "pairs": pairs}

                def launch(nb, **over):
                    build.launch_viterbi(
                        *ins, {**pl, "smem_bytes": nb, **over},
                        2.0 * 4.07 ** 2, 3.0, 5.0, 2000.0, 10.0, True, 10.0,
                        scratch, *outs)

                launch(nbytes)
                for off in (-16, 16):
                    with pytest.raises(RuntimeError, match="error -1"):
                        launch(nbytes + off)
                with pytest.raises(RuntimeError, match="error -1"):
                    launch(nbytes, instance=0)
                with pytest.raises(RuntimeError, match="error -1"):
                    launch(nbytes, pairs=0)
        torch.cuda.synchronize()
        assert not outs[4].any(), k


@pytest.mark.parametrize("i", range(8))
def test_viterbi_on_each_card_with_another_card_current(sf_tile, vit_fleet,
                                                        cuda, i):
    """The decode on cuda:i equals the plain version there; where there is
    more than one card, with a different card current (the launch runs
    under the tensors' device guard)."""
    from reporter_tpu_torch.ops import hmm

    n = torch.cuda.device_count()
    if i >= n:
        pytest.skip(f"this host has {n} card(s)")
    ts, _ = sf_tile
    dev = torch.device("cuda", i)
    tab = tables_from_numpy(ts.arrays(), dev)
    cands = dc.CandidateSet(*(x[:64].to(dev) for x in _vit_cands(
        sf_tile, vit_fleet, 8)))
    pts, valid = (x[:64].to(dev) for x in vit_fleet)
    args = (cands, pts, valid, *_vit_args(tab, 10.0))
    with torch.cuda.device((i + 1) % n):
        got = hmm.viterbi_decode_batched(*args)
        assert torch.cuda.current_device() == (i + 1) % n
    want = hmm._viterbi_plain(*args)
    torch.cuda.synchronize(dev)
    for f in _VIT_FIELDS:
        assert getattr(got, f).device == dev
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# the ranked-path lattice (kernels/lattice.cu) and the grid candidates
# (kernels/grid.cu) against their plain versions

_LAT_INPUTS = {}


def _lattice_inputs(sf_tile, k, t, radius=None):
    """The lattice of one sf trace as match_topk builds it on the card, at
    width k (50 m up to K = 8, 150 m past it, or ``radius``): a one-point
    trace (T = 1), a fleet trace (T = 120) or a 1024-point probe (T =
    1024). → (points, valid, the plain keep mask, the candidates, the
    tables, the matcher's constants, then _lattice_prep's em, active,
    prev_any, trans)."""
    from reporter_tpu_torch.config import MatcherParams
    from reporter_tpu_torch.netgen.traces import synthesize_probe
    from reporter_tpu_torch.ops import hmm

    radius = radius or (50.0 if k <= 8 else 150.0)
    if (k, t, radius) not in _LAT_INPUTS:
        ts, tab = sf_tile
        xy = synthesize_probe(ts, seed=7, num_points=max(t, 2)).xy[:t]
        pts = torch.from_numpy(xy.astype(np.float32)).cuda()
        valid = torch.ones(t, dtype=torch.bool, device="cuda")
        if t >= 120:
            valid[t // 3:t // 3 + 5] = False          # padding inside
        c = dc.find_candidates_dense(
            pts, tuple(tab[n] for n in (
                "seg_pack", "seg_bbox", "seg_sub", "seg_feat", "seg_sweep",
                "seg_coarse")), radius, k, valid=valid)
        p = MatcherParams()
        keep = hmm._keep_mask_batched(pts[:, :, None], valid[:, None],
                                      p.interpolation_distance)[:, 0]
        consts = (p.sigma_z, p.beta, p.max_route_distance_factor, 300.0,
                  p.backward_slack)
        _LAT_INPUTS[k, t, radius] = (
            pts, valid, keep, c, tab, consts,
            *hmm._lattice_prep(c, pts, keep, tab, *consts))
    return _LAT_INPUTS[k, t, radius]


@pytest.mark.parametrize("t", [1, 120, 1024])
@pytest.mark.parametrize("k,r", [(1, 1), (8, 1), (8, 2), (8, 8), (16, 1),
                                 (16, 2), (16, 16), (64, 1), (64, 2),
                                 (64, 64)])
def test_lattice_kernels_equal_plain(sf_tile, k, r, t):
    """The forward kernel from the candidates (scores, backpointers,
    started, own, and active) bit-equal to _lattice_prep +
    _forward_list_plain on the card, and the backtrack kernel (every
    path's states) to _backtrack_plain, one launch each counted."""
    from reporter_tpu_torch.ops import hmm

    pts, _, keep, c, tab, consts, em, act, pany, trans = _lattice_inputs(
        sf_tile, k, t)
    before = dict(hmm.LATTICE_LAUNCHES)
    got = hmm._forward_list(c, pts, keep, tab, *consts, r)
    want = (*hmm._forward_list_plain(em, act, pany, trans, r), act)
    torch.cuda.synchronize()
    for name, g, w in zip(("scores", "backptrs", "started", "own",
                           "active"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    # the ranked terminal states and a -1 seed, within the kernel's paths
    seed = torch.sort(want[0][-1], stable=True).indices[:max(k, r)]
    seed = torch.cat([seed[:hmm.LATTICE_MAX_K - 1],
                      seed.new_full((1,), -1)]).to(torch.int32)
    states = hmm._backtrack(want[1], want[2], act, want[3], seed)
    plain = hmm._backtrack_plain(want[1], want[2], act, want[3], seed)
    torch.cuda.synchronize()
    assert torch.equal(states, plain), int((states != plain).sum())
    after = hmm.LATTICE_LAUNCHES
    assert after["forward"] == before.get("forward", 0) + 1
    assert after["backtrack"] == before.get("backtrack", 0) + 1
    if t > 1:
        assert bool(want[2].any()) and bool((states >= 0).any())


@pytest.mark.parametrize("interp", [10.0, 0.0])
@pytest.mark.parametrize("t", [1, 120, 1024])
def test_keep_mask_kernel_equals_plain(sf_tile, t, interp):
    from reporter_tpu_torch.ops import hmm

    pts, valid = _lattice_inputs(sf_tile, 8, t)[:2]
    before = hmm.LATTICE_LAUNCHES.get("keep", 0)
    got = hmm.interpolation_keep_mask(pts, valid, interp)
    want = hmm._keep_mask_batched(pts[:, :, None], valid[:, None],
                                  interp)[:, 0]
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert hmm.LATTICE_LAUNCHES.get("keep", 0) == before + (interp > 0)
    # a batch of three traces through the batched entry
    pts3 = torch.stack([pts, pts.flip(0), pts + 7.0])
    val3 = torch.stack([valid, valid.flip(0), valid])
    got3 = hmm._keep_mask_cuda(pts3, val3, interp)
    want3 = hmm._keep_mask_batched(pts3.permute(1, 2, 0), val3.T, interp).T
    torch.cuda.synchronize()
    assert torch.equal(got3, want3)


def test_lattice_plan_smem_equals_the_kernels_layout(cuda):
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.ops import hmm

    for k in [*range(1, hmm.LATTICE_MAX_K + 1), 65, 96, 128, 256, 300]:
        for r in sorted({1, 2, k} & set(range(1, k + 1))):
            plan = hmm.lattice_plan(1024, k, r)
            chunk, place = plan["chunk"], plan["place"]
            tree = plan["tree_bytes"]
            assert build.lattice_forward_smem(k, r, chunk, place, tree) == \
                hmm.lattice_smem_bytes(k, r, chunk, place, tree), (k, r)
            if k > hmm.LATTICE_MAX_K:
                # every placement (the trees and the level only at R > 1,
                # the level only beside the rows): an array that alone
                # outgrows the card's shared memory is refused, and its
                # scratch with it
                for pl in range(32):
                    if r == 1 and pl & (hmm.LATTICE_PLACE_TREES
                                        | hmm.LATTICE_PLACE_LEVEL):
                        continue
                    if pl & hmm.LATTICE_PLACE_LEVEL and \
                            not pl & hmm.LATTICE_PLACE_ROWS:
                        assert build.lattice_forward_smem(
                            k, r, chunk, pl, tree) == -1
                        continue
                    nbytes = hmm.lattice_smem_bytes(k, r, chunk, pl, tree)
                    got = build.lattice_forward_smem(k, r, chunk, pl, tree)
                    assert got == nbytes or (got == -1 and nbytes
                                             > hmm.VITERBI_SMEM_MAX), \
                        (k, r, pl)
                    assert build.lattice_forward_scratch(
                        k, r, chunk, pl, tree) == (
                        -1 if got == -1 else
                        hmm.lattice_scratch_bytes(k, r, chunk, pl, tree)), \
                        (k, r, pl)
                if r > 1:      # a trees' region short of one tree
                    assert build.lattice_forward_smem(
                        k, r, chunk, place, 8 * (1 << (k - 1).bit_length())
                        - 16) == -1
            paths = k if r == 1 else r
            bt = hmm.backtrack_plan(1024, k * r, paths)
            if bt["instance"] == "ring":
                walkers = bt["threads"] // 32 - 1
                assert build.lattice_backtrack_smem(
                    k * r, 32 * walkers, bt["levels"], bt["stages"]) == \
                    bt["smem_bytes"], (k, r)
    # past the walkers a CTA holds, and levels off the grain of four
    assert build.lattice_forward_smem(8, 9, 1) == -1
    # the first K whose candidate rows outgrow a CTA: its layout is over
    # the card's shared memory, and so is every wider one's
    assert build.lattice_forward_smem(2509, 1, 1) == \
        hmm.lattice_smem_bytes(2509, 1, 1) > hmm.VITERBI_SMEM_MAX
    assert build.lattice_forward_smem(46341, 1, 1) > hmm.VITERBI_SMEM_MAX
    assert build.lattice_forward_smem(200_000, 1, 1) == -1
    assert build.lattice_forward_scratch(64, 1, 1, 0, 0) == -1
    assert build.lattice_backtrack_smem(8, 65, 4, 2) > 0
    assert build.lattice_backtrack_smem(8, 257, 4, 2) > 0
    assert build.lattice_backtrack_smem(8, 32 * 31 + 1, 4, 2) == -1
    assert build.lattice_backtrack_smem(8, 8, 6, 2) == -1


def test_lattice_kernels_refuse_on_the_card(sf_tile):
    """K past the shared memory's ceiling and R past K are refused before
    a launch; a wrong dtype on the card raises too; a backtrack's level
    arrays that are views off the 16-byte grain are copied, not
    refused."""
    from reporter_tpu_torch.ops import hmm

    pts, _, keep, c, tab, consts, em, act, pany, trans = _lattice_inputs(
        sf_tile, 8, 120)
    with pytest.raises(ValueError, match="1 <= R <= K"):
        hmm._forward_list(c, pts, keep, tab, *consts, 9)
    k = 2509       # the first K whose candidate rows outgrow a CTA
    wide = c._make(x[:4].repeat(1, -(-k // 8))[:, :k].contiguous()
                   for x in c)
    with pytest.raises(ValueError, match=f"K={k} .*shared memory"):
        hmm._forward_list(wide, pts[:4], keep[:4], tab, *consts, 1)
    with pytest.raises(ValueError, match="expected dist as"):
        hmm._forward_list(c._replace(dist=c.dist.double()), pts, keep, tab,
                          *consts, 1)
    want = hmm._forward_list_plain(em, act, pany, trans, 1)
    seed = torch.arange(8, dtype=torch.int32, device=pts.device)
    big = torch.cat([want[1].new_zeros(1), want[1].reshape(-1)])[1:].view(
        want[1].shape)
    assert big.data_ptr() % 16
    states = hmm._backtrack(big, want[2], act, want[3], seed)
    assert torch.equal(states, hmm._backtrack_plain(want[1], want[2], act,
                                                    want[3], seed))


@pytest.mark.parametrize("k,r,t,place", [
    (65, 1, 120, 10), (65, 65, 120, 31), (96, 1, 1024, 10),
    (96, 2, 120, 31), (96, 96, 120, 31), (96, 96, 1024, 31),
    (128, 1, 120, 10), (128, 128, 120, 13), (254, 1, 40, 10),
    (255, 2, 40, 30), (256, 256, 40, 12), (300, 1, 40, 10),
    (300, 300, 40, 12)])
def test_lattice_wide_instance_equals_plain(sf_tile, k, r, t, place):
    """Past K = 64 the forward's wide instance (each looked-up column's
    merge over its looked-up rows, in shared memory what the plan places
    there: at K = R = 96 everything, at R = 1 all but the blocks, at K = R
    = 128 all but the carried rows, past 200 the first pass and the trees
    alone; the level's backpointers beside the rows, copied out after the
    step; past K = 256 its 256 merge threads take two columns each)
    bit-equal to _lattice_prep + _forward_list_plain, and the backtrack
    (more walker warps at P > 64, the levels read in place where a level
    of K * R states is too wide for the ring) to _backtrack_plain, with
    every path of the form match_topk asks and a -1 seed."""
    from reporter_tpu_torch.ops import hmm

    pts, _, keep, c, tab, consts, em, act, pany, trans = _lattice_inputs(
        sf_tile, k, t, LONG_LIST_RADIUS)
    plan = hmm.lattice_plan(t, k, r)
    assert plan["place"] == place
    assert (plan["scratch_bytes"] > 0) == (place != 31)
    got = hmm._forward_list(c, pts, keep, tab, *consts, r)
    want = (*hmm._forward_list_plain(em, act, pany, trans, r), act)
    torch.cuda.synchronize()
    for name, g, w in zip(("scores", "backptrs", "started", "own",
                           "active"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    seed = torch.sort(want[0][-1], stable=True).indices[:k if r == 1 else r]
    seed = torch.cat([seed, seed.new_full((1,), -1)]).to(torch.int32)
    bt = hmm.backtrack_plan(t, k * r, int(seed.shape[0]))
    assert bt["instance"] == "ring" or r > 1
    states = hmm._backtrack(want[1], want[2], act, want[3], seed)
    plain = hmm._backtrack_plain(want[1], want[2], act, want[3], seed)
    torch.cuda.synchronize()
    assert torch.equal(states, plain), int((states != plain).sum())
    assert bool((states >= 0).any())


@pytest.mark.parametrize("p", [1, 65, 100, 1000, 2000])
@pytest.mark.parametrize("s", [8, 4096, 20000])
def test_backtrack_takes_any_paths_and_width(cuda, s, p):
    """The backtrack at P paths over CTAs of up to 31 walker warps, and at
    levels of S states past the ring (read in place), against the plain
    version on random levels (chains started at random, inactive levels,
    -1 backpointers and own states)."""
    from reporter_tpu_torch.ops import hmm

    g = torch.Generator().manual_seed(s + p)
    T = 300
    bp = torch.randint(-1, s, (T, s), generator=g, dtype=torch.int32)
    started = torch.rand(T, generator=g) < 0.05
    active = torch.rand(T, generator=g) < 0.9
    own = torch.randint(-1, s, (T,), generator=g, dtype=torch.int32)
    seed = torch.randint(-1, s, (p,), generator=g, dtype=torch.int32)
    args = [x.to(cuda) for x in (bp, started, active, own, seed)]
    plan = hmm.backtrack_plan(T, s, p)
    assert plan["instance"] == ("global" if s == 20000 else "ring")
    got = hmm._backtrack(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), hmm._backtrack_plain(bp, started, active,
                                                       own, seed))


def _still_and_moving(t, rng):
    """A trace that stands still (every point within 10 m of the first,
    jittered by under 5 m) for its first half and then drives off 6 to
    14 m a point, with a few invalid points."""
    still = rng.uniform(-2.5, 2.5, (max(t // 2, 1), 2))
    drive = np.cumsum(rng.uniform(6.0, 14.0, (t - t // 2, 2))
                      * rng.choice([-1.0, 1.0], (1, 2)), axis=0)
    xy = np.concatenate([still[:t // 2], still[-1] + drive]) + 1000.0
    valid = rng.random(t) > 0.05
    return xy.astype(np.float32), valid


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("t", [1, 120, 1024, 5000])
def test_keep_mask_kernel_equals_plain_in_any_shape(sf_tile, t, b):
    """The keep kernel (a CTA a trace, the chain of next kept points) at
    B = 1 and 64, T = 1, 120, 1024 and 5000 (three tiles of 2048 points):
    sf fleet traces, a trace standing still and then driving, one
    standing still throughout (every next-point search runs to its tile's
    end) and one with no valid point; bit-equal to the plain version and
    one launch a call."""
    from reporter_tpu_torch.ops import hmm

    ts, _ = sf_tile
    rng = np.random.default_rng(t + b)
    fleet = synthesize_fleet(ts, b, num_points=max(t, 2), seed=t)
    pts = np.zeros((b, t, 2), np.float32)
    valid = rng.random((b, t)) > 0.1
    for i, f in enumerate(fleet):
        n = min(len(f.xy), t)
        pts[i, :n] = f.xy[:n]
        valid[i, n:] = False
    pts[0], valid[0] = _still_and_moving(t, rng)
    if b > 1:
        pts[1] = pts[1, :1] + rng.uniform(-2.0, 2.0, (t, 2))
        valid[1] = True
        valid[2] = False
    p = torch.from_numpy(pts).to("cuda")
    v = torch.from_numpy(valid).to("cuda")
    for interp in (10.0, 0.5):
        before = hmm.LATTICE_LAUNCHES.get("keep", 0)
        got = hmm._keep_mask_cuda(p, v, interp)
        want = hmm._keep_mask_batched(p.permute(1, 2, 0), v.T, interp).T
        torch.cuda.synchronize()
        assert hmm.LATTICE_LAUNCHES["keep"] == before + 1
        assert got.dtype == torch.bool and torch.equal(got, want), \
            int((got != want).sum())
        if t > 1 and interp == 10.0:
            # standing still: one kept point in the first half
            assert int(want[0, :t // 2].sum()) == 1


_GRID_TILES = {}


def _grid_tile(metro, radius):
    from reporter_tpu_torch.config import CompilerParams

    if (metro, radius) not in _GRID_TILES:
        ts = compile_network(generate_city(metro),
                             CompilerParams(index_radius=radius))
        _GRID_TILES[metro, radius] = (ts, tables_from_numpy(
            ts.arrays(), "cuda", candidate_backend="grid"))
    return _GRID_TILES[metro, radius]


@pytest.mark.parametrize("metro", ["sf", "organic"])
@pytest.mark.parametrize("k,radius", [(1, 50.0), (8, 50.0), (64, 150.0),
                                      (96, 150.0), (8, 300.0)])
def test_grid_kernel_equals_plain(cuda, metro, k, radius):
    """The grid kernel's four fields byte-equal to the plain version's on
    the card: fleet points, every node (d = 0 ties) and points past the
    grid's edge; one launch counted under K. The row holds 64 slots at 50
    m and more at 150 and 300 m (128 and 256 on sf)."""
    from reporter_tpu_torch.ops import candidates as cand

    ts, tab = _grid_tile(metro, radius)
    rng = np.random.default_rng(4)
    pts = np.concatenate([
        np.concatenate([p.xy for p in synthesize_fleet(ts, 64, seed=3)]),
        ts.node_xy, rng.uniform(ts.node_xy.min(0) - 300,
                                ts.node_xy.max(0) + 300, (4000, 2))])
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    before = cand.GRID_LAUNCHES.get(k, 0)
    got = cand.find_candidates(pts, tab, ts.meta, radius, k)
    want = cand._find_candidates_plain(pts, tab, ts.meta, radius, k)
    torch.cuda.synchronize()
    assert cand.GRID_LAUNCHES[k] == before + 1
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes(), name
    assert bool(want.valid.any())
    if k == 64:
        assert bool((want.valid.sum(1) > 16).any())
    if radius > 50.0:
        assert int(tab["cell_pack"].shape[1]) // 8 > 64
    # a leading batch shape and an empty batch
    got2 = cand.find_candidates(pts[:120].reshape(4, 30, 2), tab, ts.meta,
                                radius, k)
    assert torch.equal(got2.edge.reshape(120, k), got.edge[:120])
    empty = cand.find_candidates(pts[:0], tab, ts.meta, radius, k)
    assert empty.edge.shape == (0, k)
