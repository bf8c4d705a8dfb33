"""The CUDA sweep kernel (reporter_tpu_torch/kernels/sweep.cu) against its
plain PyTorch versions, on the card. Candidates, every arm: tolerance 0
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
def sf(cuda):
    """The sf tile's tables and a point set: fleet traces, every node (d =
    0 ties) and uniform points past the tile's edge; 10% invalid."""
    ts = compile_network(generate_city("sf"))
    tab = tables_from_numpy(ts.arrays(), cuda)
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
    before = dc.SWEEP_LAUNCHES[arm]
    got = dc.find_candidates_dense(
        pts, (tab["seg_pack"], tab["seg_bbox"], tab["seg_sub"],
              tab["seg_feat"]), 50.0, 8, valid=valid, **levers)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8)
    torch.cuda.synchronize()
    assert dc.SWEEP_LAUNCHES[arm] == before + 1
    for g, r in zip((got.edge, got.offset, got.dist), ref):
        assert torch.equal(g[valid], r[valid])


def _kernel_gate(tab, pts, valid, arm):
    n = len(pts)
    nchunks = -(-n // dc._P)
    fpts, fval = dc._fill_invalid(pts, valid, nchunks)
    ids, nhits = dc._chunk_block_ids(fpts, fval, tab["seg_bbox"], 50.0,
                                     nchunks)
    log = torch.zeros((nchunks, dc._P // 32, ids.shape[1]), dtype=torch.int32,
                      device=pts.device)
    dc.sweep_topk(fpts, ids, nhits, tab["seg_pack"], tab["seg_sub"],
                  tab["seg_feat"], 50.0, 8, arm, gate_log=log)
    torch.cuda.synchronize()
    return fpts, ids, nhits, dc.decode_gate_log(log)


def test_bf16_gate_equals_plain(sf):
    tab, pts, valid = sf
    fpts, ids, nhits, got = _kernel_gate(tab, pts, valid, "sub_bf16")
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
           zip(("seg_pack", "seg_bbox", "seg_sub", "seg_feat"), sp)}
    rng = np.random.default_rng(4)
    centres = rng.uniform(0.0, 4000.0, (256, 1, 2))
    pts = (centres + rng.uniform(-30.0, 30.0, (256, 32, 2))).reshape(-1, 2)
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    return tab, pts, torch.ones(len(pts), dtype=torch.bool, device=cuda)


@pytest.mark.parametrize("tile", ["sf", "rows"])
@pytest.mark.parametrize("arm", ["mxu", "mxu_bf16"])
def test_tensor_core_gate_agrees_with_plain(request, tile, arm):
    tab, pts, valid = request.getfixturevalue(tile)
    fpts, ids, nhits, got = _kernel_gate(tab, pts, valid, arm)
    want = dc._coarse_mxu_gate(fpts, ids, nhits, tab["seg_sub"],
                               tab["seg_feat"], 50.0,
                               "bf16" if arm == "mxu_bf16" else "off")
    assert torch.equal(got.vote, want.vote)
    differ = got.gate != want.gate
    near = (want.cmin - want.thr).abs() <= GATE_REL_TOL * want.thr
    assert not (differ & ~near).any()
    if tile == "rows":
        assert int(want.gate.sum()) < int(want.vote.sum())


def test_sweep_wrapper_rejects_bad_input(cuda):
    pts = torch.zeros((256, 2), device=cuda)
    ids = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    nhits = torch.zeros(1, dtype=torch.int32, device=cuda)
    pack = torch.zeros((8, 512), device=cuda)
    with pytest.raises(ValueError):
        dc.sweep_topk(pts.cpu(), ids, nhits, pack, None, None, 50.0, 8, "block")
    with pytest.raises(ValueError):
        dc.sweep_topk(pts, ids, nhits, pack, None, None, 50.0, 4, "block")
    with pytest.raises(ValueError):      # the mxu arm without feat rows
        dc.sweep_topk(pts, ids, nhits, pack, torch.zeros((1, 16), device=cuda),
                      None, 50.0, 8, "mxu")
