"""The grid candidate backend's kernel (kernels/grid.cu) on the CPU: numpy
models of its algorithm held to the port's plain version at tolerance 0,
and the wrapper's refusals.

- The distinct-edge list as the kernel ranks it, with no loop over K: the
  valid slots (key < BIG) compacted in slot order, each an edge's
  representative where no other compacted slot of its edge has a smaller
  (key bits << 32 | slot), each representative placed by the count of
  representatives before it, the places below K written and the rest
  empty; held to ``_topk_distinct_edges`` (edges, slots, picked) on rows
  with one edge at equal d² in two slots, equal d² across two edges,
  fewer distinct edges than K, all-BIG rows and tie-heavy random rows.
- The whole kernel in numpy f32 (the cell index, _point_segment_dist's
  operation order, the radius test, the list, the four outputs) against
  ``_find_candidates_plain`` on the tiny and organic tiles' fleets and
  points past the grid, at K = 1, 8 and 64 and two radii: the four fields
  byte-equal.
- ``launch_grid`` refuses a wrong dtype, shape or device before it
  builds; ``find_candidates`` refuses a device that is neither.

The kernel itself runs on the card: tests/test_torch_kernels_gpu.py. The
port's grid candidates against the JAX package's: tests/test_torch_grid.py.
"""

import numpy as np
import pytest
import torch

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import CompilerParams
from reporter_tpu_torch.kernels import build
from reporter_tpu_torch.netgen.synthetic import generate_city
from reporter_tpu_torch.netgen.traces import synthesize_fleet
from reporter_tpu_torch.ops import candidates as cand
from reporter_tpu_torch.ops.dense_candidates import BIG
from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import (PACK_AX, PACK_AY, PACK_BX,
                                              PACK_BY, PACK_EDGE, PACK_LEN,
                                              PACK_NCOMP, PACK_OFF,
                                              tables_from_numpy)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

F32 = np.float32


def distinct_list(edges: np.ndarray, keys: np.ndarray, k: int):
    """The kernel's list for one point's row (edges i32 [C], keys f32 [C]:
    d² or BIG): → (edge [K], slot [K], picked [K]) as
    _topk_distinct_edges gives them (an unpicked place: edge -1, slot
    0)."""
    keys = keys.astype(F32)
    C = len(keys)
    packed = (keys.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | np.arange(C, dtype=np.uint64)
    # 1. the valid slots, compacted in slot order
    at = np.flatnonzero(keys < F32(BIG))
    ck, ce = packed[at], edges[at]
    # 2. a representative: no compacted slot of its edge with a smaller key
    rep = np.array([not ((ce == ce[a]) & (ck < ck[a])).any()
                    for a in range(len(at))], bool)
    out_e = np.full(k, -1, np.int64)
    out_i = np.zeros(k, np.int64)
    ok = np.zeros(k, bool)
    # 3. a representative's place: the representatives before it
    for a in np.flatnonzero(rep):
        place = int((rep & (ck < ck[a])).sum())
        if place < k:
            j = int(ck[a] & np.uint64(0xffffffff))
            out_e[place], out_i[place], ok[place] = edges[j], j, True
    # 4. the places past the list stay empty
    assert ok.sum() == min(int(rep.sum()), k) and ok[:int(ok.sum())].all()
    return out_e, out_i, ok


def _plain_list(edges, keys, k):
    e, i, _, ok = cand._topk_distinct_edges(
        torch.from_numpy(edges.astype(np.int32))[None],
        torch.from_numpy(keys.astype(F32))[None],
        torch.zeros((1, len(keys)), dtype=torch.float32), k)
    return e[0].numpy(), i[0].numpy(), ok[0].numpy()


def _rows():
    """(edges, keys) rows: one edge at equal d² in two slots (the first
    slot wins), equal d² across two edges (the smaller slot first), fewer
    distinct edges than K, all BIG, an empty slot (edge -1) at BIG, and
    tie-heavy random rows."""
    big = F32(BIG)
    yield (np.array([3, 3, 5, 7, 7, 2]),
           np.array([4.0, 4.0, 4.0, 1.0, 1.0, 9.0], F32))
    yield (np.array([8, 6, 6, 8, 4]),
           np.array([2.0, 2.0, 2.0, 0.5, 2.0], F32))
    yield (np.array([1, 1, 1, 9, -1, -1]),
           np.array([2.0, 1.0, 1.0, 5.0, big, big], F32))
    yield np.array([4, 5, -1, 6]), np.full(4, big, F32)
    rng = np.random.default_rng(3)
    for _ in range(60):
        C = int(rng.integers(1, 70))
        edges = np.sort(rng.integers(-1, 12, C))
        keys = rng.integers(0, 4, C).astype(F32)
        keys[(edges < 0) | (rng.random(C) < 0.2)] = big
        yield edges, keys


@pytest.mark.parametrize("k", [1, 2, 8, 64])
def test_distinct_list_equals_the_plain_steps(k):
    for edges, keys in _rows():
        got = distinct_list(edges, keys, k)
        want = _plain_list(edges, keys, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def kernel_model(pts: np.ndarray, pack: np.ndarray, gm, radius: float,
                 k: int):
    """grid.cu in numpy f32: per point the cell (floor of (v - o) /
    cell, clamped in float to [-1, n], then to the grid), each slot's d²
    and t in _point_segment_dist's order, the key, the list and the four
    outputs. → (edge i32, offset f32, dist f32, valid bool), each [N,
    K]."""
    C = pack.shape[1] // PACK_NCOMP
    rows = pack.reshape(len(pack), PACK_NCOMP, C)
    N = len(pts)
    edge = np.full((N, k), -1, np.int32)
    offset = np.zeros((N, k), F32)
    dist = np.full((N, k), BIG, F32)
    valid = np.zeros((N, k), bool)
    cell, r = F32(gm.cell_size), F32(radius)

    def axis(v, o, n):
        q = np.floor((v - F32(o)) / cell)
        return int(min(max(int(min(max(q, F32(-1.0)), F32(n))), 0), n - 1))

    for i, (px, py) in enumerate(pts.astype(F32)):
        row = rows[axis(px, gm.ox, gm.gw) * gm.gh + axis(py, gm.oy, gm.gh)]
        ax, ay, bx, by = (row[c] for c in (PACK_AX, PACK_AY, PACK_BX,
                                           PACK_BY))
        e = row[PACK_EDGE].view(np.int32)
        abx, aby = bx - ax, by - ay
        denom = np.maximum(abx * abx + aby * aby, F32(1e-12))
        t = np.minimum(np.maximum(((px - ax) * abx + (py - ay) * aby)
                                  / denom, F32(0.0)), F32(1.0))
        dx, dy = px - (ax + t * abx), py - (ay + t * aby)
        d2 = dx * dx + dy * dy
        keys = np.where((e >= 0) & (np.sqrt(d2) <= r), d2, F32(BIG))
        es, js, ok = distinct_list(e, keys, k)
        for q in np.nonzero(ok)[0]:
            j = js[q]
            edge[i, q] = es[q]
            offset[i, q] = row[PACK_OFF, j] + t[j] * row[PACK_LEN, j]
            dist[i, q] = np.sqrt(d2[j])
            valid[i, q] = True
    return edge, offset, dist, valid


@pytest.fixture(scope="module", params=["tiny", "organic"])
def grid_tile(request):
    """A tile compiled with a 150 m index radius (so the 150 m search
    runs), its grid tables on the CPU, and points: a few fleet traces,
    some nodes (d = 0 ties) and points past the grid's edge."""
    ts = compile_network(generate_city(request.param),
                         CompilerParams(index_radius=150.0))
    tab = tables_from_numpy(ts.arrays(), "cpu", candidate_backend="grid")
    rng = np.random.default_rng(5)
    pts = np.concatenate([
        np.concatenate([p.xy for p in synthesize_fleet(ts, 3, seed=2,
                                                       num_points=40)]),
        ts.node_xy[:40],
        rng.uniform(ts.node_xy.min(0) - 300, ts.node_xy.max(0) + 300,
                    (60, 2))]).astype(F32)
    return ts, tab, pts


@pytest.mark.parametrize("radius,k", [(50.0, 1), (50.0, 8), (150.0, 8),
                                      (150.0, 64)])
def test_kernel_model_equals_the_plain_version(grid_tile, radius, k):
    ts, tab, pts = grid_tile
    want = cand._find_candidates_plain(torch.from_numpy(pts), tab, ts.meta,
                                       radius, k)
    got = kernel_model(pts, tab["cell_pack"].numpy(),
                       cand.as_grid_meta(ts.meta), radius, k)
    for name, g, w in zip(want._fields, got, want):
        assert g.tobytes() == w.numpy().tobytes(), name
    assert want.valid.any()
    if radius == 150.0 and k == 64:
        assert (want.valid.sum(1) > 16).any()      # lists past 16 edges


def test_launch_grid_refuses_dtype_shape_and_device(grid_tile):
    ts, tab, pts = grid_tile
    gm = cand.as_grid_meta(ts.meta)
    pack = tab["cell_pack"]
    n, k = 5, 8
    pts_t = torch.from_numpy(pts[:n])
    outs = (torch.empty((n, k), dtype=torch.int32), torch.empty((n, k)),
            torch.empty((n, k)), torch.empty((n, k), dtype=torch.bool))
    geo = (gm.ox, gm.oy, gm.cell_size, gm.gw, gm.gh, 50.0)
    with pytest.raises(ValueError, match="expected pts as"):
        build.launch_grid(pts_t.double(), pack, *geo, *outs)
    with pytest.raises(ValueError, match="expected cell_pack as"):
        build.launch_grid(pts_t, pack, gm.ox, gm.oy, gm.cell_size, gm.gw + 1,
                          gm.gh, 50.0, *outs)
    with pytest.raises(ValueError, match="expected cell_pack"):
        build.launch_grid(pts_t, pack[:, :-1], *geo, *outs)
    with pytest.raises(ValueError, match="expected valid as"):
        build.launch_grid(pts_t, pack, *geo, *outs[:3], outs[3].int())
    with pytest.raises(ValueError, match="on the card"):
        build.launch_grid(pts_t, pack, *geo, *outs)
    with pytest.raises(ValueError, match="unsupported device"):
        cand.find_candidates(torch.empty((n, 2), device="meta"), tab,
                             ts.meta, 50.0, k)
    before = dict(cand.GRID_LAUNCHES)
    cand.find_candidates(pts_t, tab, ts.meta, 50.0, k)
    assert cand.GRID_LAUNCHES == before
