"""The CUDA sweep kernel (reporter_tpu_torch/kernels/sweep.cu) against its
plain PyTorch version, on the card. Tolerance 0: both are the same f32
arithmetic, one rounding per operation.

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


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("subcull", [True, False])
def test_sweep_kernel_equals_plain(cuda, subcull):
    ts = compile_network(generate_city("sf"))
    tab = tables_from_numpy(ts.arrays(), cuda)
    rng = np.random.default_rng(0)
    fleet = np.concatenate([p.xy for p in synthesize_fleet(ts, 64, seed=3)])
    pts = np.concatenate([
        fleet, ts.node_xy,
        rng.uniform(ts.node_xy.min(0) - 60, ts.node_xy.max(0) + 60, (4000, 2))])
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    valid = torch.rand(len(pts), generator=torch.Generator().manual_seed(1)) < 0.9
    valid = valid.to(cuda)
    got = dc.find_candidates_dense(
        pts, (tab["seg_pack"], tab["seg_bbox"], tab["seg_sub"]), 50.0, 8,
        valid=valid, subcull=subcull)
    ref = dc._dense_plain(pts, tab["seg_pack"], 50.0, 8)
    torch.cuda.synchronize()
    for g, r in zip((got.edge, got.offset, got.dist), ref):
        assert torch.equal(g[valid], r[valid])


def test_sweep_wrapper_rejects_bad_input(cuda):
    pts = torch.zeros((256, 2), device=cuda)
    ids = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    nhits = torch.zeros(1, dtype=torch.int32, device=cuda)
    pack = torch.zeros((8, 512), device=cuda)
    with pytest.raises(ValueError):
        dc.sweep_topk(pts.cpu(), ids, nhits, pack, None, 50.0, 8)
    with pytest.raises(ValueError):
        dc.sweep_topk(pts, ids, nhits, pack, None, 50.0, 4)
